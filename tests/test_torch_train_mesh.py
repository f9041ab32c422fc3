"""Mesh training through the port's entry point, on gloo ranks on the CPU,
against the port's single-device training and the JAX package's
``train_step`` (the counterpart of ``tests/test_train_mesh.py``).

One module-scoped fixture starts this file as two ranks, then as four
(``parallel.launch``, the launches serialised across test workers). Every
rank runs a list of jobs and writes, for each, its losses and the whole
trees gathered from the shards (``parallel.mesh.unshard_tree``); this
process holds them against references:

  - ``run_training`` of the tiny config of ``tests/test_train_mesh.py``
    (cond drop 0.1 and drop path 0.1, so the draws are sliced) on 1x2,
    2x1 and 2x2 meshes against the single-device ``run_training`` on the
    same global batches (with a data split the mesh's sampler hands rank r
    the r-th share of each global batch: the reference reads the ranks'
    shares in rank order): losses and global gradient norms within
    rtol/atol 1e-4, parameters within 2e-4; the replicated leaves
    bit-equal across the ranks; the token path (``token_root``) on 2x1
    the same way;
  - the first step's gradient of every leaf from JAX's weights, averaged
    over "data" and gathered, within 1e-4 of the leaf's size of the JAX
    package's; then two AdamW ``train_step``s from JAX's state
    (``train_state_from_jax``) against the JAX package's on the same numpy
    batch (deterministic forward), on 1x2 and 2x1, at the same
    tolerances; the factored optimizer (a width of 128, so that leaves
    factor, and a split axis is reduced) the same way against the port on
    one process (which ``test_torch_trainer.py`` holds against JAX);
  - ``vae_train_step`` on 2x1, two steps: the hits summed over "data"
    and the gradients averaged, so the parameters stay equal across the
    ranks and equal to one process's on the whole batch;
  - on 2x1, ``run_training`` stopped at step 2 and resumed to step 4
    bit-equal to the run straight to step 4;
  - an indivisible width under training: 6 heads at model=4 (the heads'
    layers whole on every rank, the other widths split);
  - the checkpoint a mesh run wrote loaded on one process equal bit for
    bit to the gathered state, and a single-device checkpoint resumed on
    1x2 and 2x1 against the single-device resume.

The sampler's partition and its resume mid-epoch are single-process
cases at the end.
"""

import os
import shutil
import sys
from unittest import mock

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a rank: python tests/test_torch_train_mesh.py
    sys.path.insert(0, REPO)

from sdvar_tpu_torch.config import (  # noqa: E402
    MeshConfig,
    TrainConfig,
    VARConfig,
    VQVAEConfig,
)
from sdvar_tpu_torch.models.vqvae import init_vqvae_params  # noqa: E402
from sdvar_tpu_torch.ops import partition as PT  # noqa: E402
from sdvar_tpu_torch.parallel import distributed as D  # noqa: E402
from sdvar_tpu_torch.parallel import mesh as MS  # noqa: E402
from sdvar_tpu_torch.parallel.launch import launch  # noqa: E402
from sdvar_tpu_torch.train import checkpoint as CK  # noqa: E402
from sdvar_tpu_torch.train import trainer as T  # noqa: E402
from sdvar_tpu_torch.train import train_loop as TL  # noqa: E402
from sdvar_tpu_torch.train.data import DistInfiniteBatchSampler  # noqa: E402

PNS = (1, 2, 3)
ITERS = 3
F32 = torch.float32
TC = dict(reso=48, global_batch_size=4, epochs=1, label_smooth=0.1)
VAE_KW = dict(vocab_size=64, z_channels=8, ch=32, patch_nums=PNS)
# the JAX comparison: tests/test_torch_trainer.py's stack
JAX_KW = dict(depth=2, num_classes=10, patch_nums=PNS, vocab_size=64, Cvae=8,
              cond_drop_rate=0.0, drop_path_rate=0.0)
LR, WD = 1e-4, 0.05
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "1x4": (1, 4)}
VAE_STEPS = 2
VAE_LOSSES = ("loss", "rec_loss", "vq_loss")


def _var_kw(name: str) -> dict:
    """``tiny``: tests/test_train_mesh.py's (4 heads of 64, V=64) with
    drop path; ``six``: 6 heads of 32, whole at model=4."""
    depth, hd = {"tiny": (4, 64), "six": (6, 32)}[name]
    return dict(depth=depth, patch_nums=PNS, vocab_size=64, Cvae=8,
                num_classes=1000, head_dim=hd, drop_path_rate=0.1)


def _jobs():
    """(world, job) in launch order; a job names its kind, mesh and what
    it trains."""
    jobs = []
    for tag in ("1x2", "2x1"):
        jobs += [(2, {"name": f"run_{tag}", "kind": "run", "mesh": tag,
                      "cfg": "tiny"}),
                 (2, {"name": f"resume_{tag}", "kind": "resume", "mesh": tag,
                      "cfg": "tiny"})]
        for opt in ("adamw", "adafactor"):
            jobs.append((2, {"name": f"jax_{opt}_{tag}", "kind": "jax",
                             "mesh": tag, "opt": opt}))
    jobs.append((2, {"name": "tokens_2x1", "kind": "run", "mesh": "2x1",
                     "cfg": "tiny", "tokens": True}))
    jobs.append((2, {"name": "vae_2x1", "kind": "vae", "mesh": "2x1"}))
    jobs.append((2, {"name": "stop_resume_2x1", "kind": "stop_resume",
                     "mesh": "2x1", "cfg": "tiny"}))
    jobs += [(4, {"name": "run_2x2", "kind": "run", "mesh": "2x2",
                  "cfg": "tiny"}),
             (4, {"name": "run_six_1x4", "kind": "run", "mesh": "1x4",
                  "cfg": "six"})]
    return jobs


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.strip("/").split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


class _NoSink:
    """A TensorboardSink that writes nothing: importing TensorBoard takes
    seconds a process, and these runs are held to their numbers."""

    def __init__(self, *a, **k):
        pass

    def update(self, *a, **k):
        pass

    def close(self):
        pass


def _state_tree(state):
    return {"params": state.params, "opt_state": state.opt_state}


def _jax_var_cfg(opt: str) -> VARConfig:
    return VARConfig(**JAX_KW, head_dim=64 if opt == "adafactor" else 32)


# ---------------------------------------------------------------------------
# one rank (this file run as a script)
# ---------------------------------------------------------------------------

def _rank_run(job, out_dir):
    data, model = MESHES[job["mesh"]]
    var_cfg, vae_cfg = VARConfig(**_var_kw(job["cfg"])), VQVAEConfig(**VAE_KW)
    tc = TrainConfig(depth=var_cfg.depth, **TC)
    run_dir = os.path.join(out_dir, job["name"])
    iters = 3 if job["kind"] == "resume" else ITERS
    state, hist = TL.run_training(
        tc, out_dir=run_dir, max_iters=iters, dtype=F32,
        mesh_cfg=MeshConfig(data=data, model=model), var_cfg=var_cfg,
        vae_cfg=vae_cfg, device="cpu",
        token_root=os.path.join(out_dir, "tokens") if job.get("tokens") else None)
    mesh = MS.create_mesh(MeshConfig(data=data, model=model))
    specs = T.train_state_specs(state.params, var_cfg, mesh)
    whole = MS.unshard_tree(_state_tree(state), {k: specs[k] for k in
                                                 ("params", "opt_state")}, mesh)
    res = {f"w{k}": v for k, v in _flat(whole).items()}
    res["loss"] = np.array([h["loss"] for h in hist])
    res["grad_norm"] = np.array([h["grad_norm"] for h in hist])
    res["it"] = np.array([h["it"] for h in hist])
    res["local_qkv_cols"] = np.array(state.params["blocks"]["qkv_w"].shape[-1])
    return res


def _rank_stop_resume(job, out_dir):
    """run_training straight to step 4, and to step 2 then resumed to 4
    in another directory: the whole trees of both."""
    data, model = MESHES[job["mesh"]]
    var_cfg, vae_cfg = VARConfig(**_var_kw(job["cfg"])), VQVAEConfig(**VAE_KW)
    tc = TrainConfig(depth=var_cfg.depth, **TC)
    mesh = MS.create_mesh(MeshConfig(data=data, model=model))
    res = {}
    for tag, stops in (("straight", (4,)), ("resumed", (2, 4))):
        for iters in stops:
            state, hist = TL.run_training(
                tc, out_dir=os.path.join(out_dir, f"{job['name']}_{tag}"),
                max_iters=iters, dtype=F32,
                mesh_cfg=MeshConfig(data=data, model=model), var_cfg=var_cfg,
                vae_cfg=vae_cfg, device="cpu")
        specs = T.train_state_specs(state.params, var_cfg, mesh)
        whole = MS.unshard_tree(_state_tree(state), {
            k: specs[k] for k in ("params", "opt_state")}, mesh)
        res.update({f"{tag}{k}": v for k, v in _flat(whole).items()})
        res[f"{tag}_it"] = np.array([h["it"] for h in hist])
    return res


def _vae():
    return init_vqvae_params(VQVAEConfig(**VAE_KW), seed=0, device="cpu",
                             eini=1.0)


def _rank_jax(job, inp):
    """Two train_steps from JAX's initial state, carried over by
    ``train_state_from_jax`` from the arrays the parent wrote."""
    from collections import namedtuple
    from types import SimpleNamespace

    from sdvar_tpu_torch.utils.from_jax import train_state_from_jax

    data, model = MESHES[job["mesh"]]
    opt = job["opt"]
    var_cfg, vae_cfg = _jax_var_cfg(opt), VQVAEConfig(**VAE_KW)
    pre = f"jax_{opt}_state/"
    tree = _unflat({k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)})
    inner = namedtuple("ScaleByAdamState" if opt == "adamw" else "FactoredState",
                       sorted(tree["opt_state"]))(**tree["opt_state"])
    state = train_state_from_jax(SimpleNamespace(
        params=tree["params"], opt_state=((), inner), step=np.int32(0)),
        device="cpu")
    vae = _vae()
    mesh = MS.create_mesh(MeshConfig(data=data, model=model))
    PT.set_tp_mesh(mesh)
    try:
        state = T.shard_train_state(state, var_cfg, mesh, opt)
        rows = mesh.rows(inp["img"].shape[0])
        img = torch.from_numpy(inp["img"][rows])
        label = torch.from_numpy(inp["label"][rows])
        # the gradients of the first step, averaged over "data", gathered
        leaves = T.tree_map(lambda t: t.detach().requires_grad_(), state.params)
        _, gt, x_in = T.tokenize(var_cfg, vae_cfg, vae, img)
        loss, _ = T.loss_and_metrics(var_cfg, leaves, label, x_in, gt, None,
                                     0.1, dtype=F32)
        flat = [t for _, t in T.tree_leaves(leaves)]
        it = iter(PT.mean_over_data(torch.autograd.grad(loss, flat)))
        grads = MS.unshard_tree(T.tree_map(lambda _: next(it), leaves),
                                MS.var_param_specs(var_cfg, mesh), mesh)
        losses, gnorms = [], []
        ptrs = _storages(state)
        for _ in range(2):
            state, m = T.train_step(var_cfg, vae_cfg, state, vae, img, label,
                                    LR, WD, None, label_smooth=0.1, dtype=F32,
                                    optimizer=opt)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        kept = _storages(state) == ptrs
        specs = T.train_state_specs(state.params, var_cfg, mesh, opt)  # shards
        whole = MS.unshard_tree(_state_tree(state), {
            k: specs[k] for k in ("params", "opt_state")}, mesh)
    finally:
        PT.set_tp_mesh(None)
    res = {f"w{k}": v for k, v in _flat(whole).items()}
    res.update({f"g{k}": v for k, v in _flat(grads).items()})
    res["loss"], res["grad_norm"] = np.array(losses), np.array(gnorms)
    res["kept_storage"] = np.array(kept)
    return res


def _storages(state):
    """The data pointer of every leaf of a train state, by path."""
    return {p: t.data_ptr() for p, t in T.tree_leaves(_state_tree(state))}


def _rank_vae(job, inp):
    """Two vae_train_steps on this rank's rows with the mesh registered:
    the hits are summed and the gradients and losses averaged over
    "data"."""
    from sdvar_tpu_torch.train import vae_trainer as VT

    mesh = MS.create_mesh(MeshConfig(*MESHES[job["mesh"]]))
    PT.set_tp_mesh(mesh)
    res = {}
    try:
        cfg = VQVAEConfig(**VAE_KW)
        st = VT.init_vae_train_state(cfg, _vae())
        rows = mesh.rows(inp["img"].shape[0])
        ptrs = [t.data_ptr() for _, t in T.tree_leaves(
            {"params": st.params, "ema": st.ema_hits_SV})]
        for i in range(VAE_STEPS):
            st, m = VT.vae_train_step(cfg, st, torch.from_numpy(inp["img"][rows]),
                                      1e-3)
            # a copy: the next step writes into the tracker
            res[f"ema{i}"] = st.ema_hits_SV.numpy().copy()
            res[f"usage{i}"] = m["usage_per_scale"].numpy()
            res[f"losses{i}"] = np.array([float(m[k]) for k in VAE_LOSSES])
    finally:
        PT.set_tp_mesh(None)
    res["kept_storage"] = np.array(ptrs == [t.data_ptr() for _, t in T.tree_leaves(
        {"params": st.params, "ema": st.ema_hits_SV})])
    res.update({f"p{k}": v for k, v in _flat(st.params).items()})
    return res


def _rank_main(out_dir: str) -> None:
    torch.set_num_threads(1)
    TL.TensorboardSink = _NoSink
    D.initialize()
    rank, world = D.get_rank(), D.get_world_size()
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    for w, job in _jobs():
        if w != world:
            continue
        res = {"jax": lambda: _rank_jax(job, inp),
               "vae": lambda: _rank_vae(job, inp),
               "stop_resume": lambda: _rank_stop_resume(job, out_dir)}.get(
                   job["kind"], lambda: _rank_run(job, out_dir))()
        np.savez(os.path.join(out_dir, f"{job['name']}_rank{rank}.npz"), **res)
    D.shutdown()


if __name__ == "__main__":
    _rank_main(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# this process: the references and the checks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This process's references on one intra-op thread, as each rank runs:
    under a loaded test run, 8 threads per worker made the small CPU
    steps of this file many times slower; the count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _MeshBatches:
    """The global batches a data=d mesh trains on: each iteration the
    ranks' shares of the sampler, in rank order (what the mesh's rows are,
    concatenated over "data")."""

    data = 1

    def __init__(self, n, bs, world_size=1, rank=0, seed=0):
        self.parts = [DistInfiniteBatchSampler(n, bs, self.data, r, seed)
                      for r in range(self.data)]
        self.iters_per_ep = self.parts[0].iters_per_ep
        self.epoch, self.start_it = 0, 0

    def __iter__(self):
        for p in self.parts:
            p.epoch, p.start_it = self.epoch, self.start_it
        its = [iter(p) for p in self.parts]
        while True:
            yield [i for it in its for i in next(it)]


def _single(cfg_name, out, data, iters=ITERS, tokens=None):
    """The single-device run_training on the batches a data=``data`` mesh
    reads."""
    var_cfg, vae_cfg = VARConfig(**_var_kw(cfg_name)), VQVAEConfig(**VAE_KW)
    tc = TrainConfig(depth=var_cfg.depth, **TC)
    sampler = type("S", (_MeshBatches,), {"data": data})
    with mock.patch.object(TL, "DistInfiniteBatchSampler", sampler), \
            mock.patch.object(TL, "TensorboardSink", _NoSink):
        return TL.run_training(tc, out_dir=out, max_iters=iters, dtype=F32,
                               var_cfg=var_cfg, vae_cfg=vae_cfg, device="cpu",
                               token_root=tokens)


def _jax_refs(inp):
    """References of the two train_steps from JAX's initial state on
    tests/test_torch_trainer.py's stack: AdamW, the JAX package's own
    (gradients and steps jitted); the factored optimizer, the port's on
    one process (held against the JAX package's by
    ``test_torch_trainer.py::test_train_steps_match_jax[adafactor]``)."""
    import jax
    import jax.numpy as jnp

    from sdvar_tpu.config import VARConfig as JVARConfig
    from sdvar_tpu.config import VQVAEConfig as JVQVAEConfig
    from sdvar_tpu.models import quantizer as JQ
    from sdvar_tpu.models import var as JM
    from sdvar_tpu.models import vqvae as JVQ
    from sdvar_tpu.train import trainer as JT
    from sdvar_tpu_torch.utils.from_jax import train_state_from_jax

    vp = _numpy(_vae())
    jvae = JVQVAEConfig(**VAE_KW)
    out = {}
    for opt in ("adamw", "adafactor"):
        kw = dict(JAX_KW, head_dim=64 if opt == "adafactor" else 32)
        jcfg = JVARConfig(**kw)
        p = jax.tree.map(np.asarray, JM.init_var_params(jcfg, jax.random.PRNGKey(1)))
        p["blocks"]["ada_lin_b"] = np.random.default_rng(1).normal(
            0, 0.3, p["blocks"]["ada_lin_b"].shape).astype(np.float32)
        st = JT.init_train_state(jax.tree.map(jnp.asarray, p), optimizer=opt)
        start = jax.tree.map(np.asarray, st)
        for k, v in _flat_np(start.params, "params").items():
            inp[f"jax_{opt}_state/{k}"] = v
        for k, v in _flat_np(_optax_tree(start.opt_state, opt), "opt_state").items():
            inp[f"jax_{opt}_state/{k}"] = v
        if opt == "adafactor":
            out[opt] = _port_refs(_jax_var_cfg(opt), train_state_from_jax(
                start, device="cpu"), inp)
            continue
        img, label = jnp.asarray(inp["img"]), jnp.asarray(inp["label"])

        ids = jax.jit(JVQ.img_to_idxBl, static_argnums=0)(jvae, vp, img)
        x_in = JQ.idx_to_var_input(jvae, vp["quant"], ids)
        grads = jax.jit(jax.grad(lambda q, x, gt: JT.loss_and_metrics(
            jcfg, q, label, x, gt, None, 0.1, dtype=jnp.float32)[0]))(
                jax.tree.map(jnp.asarray, p), x_in, jnp.concatenate(ids, axis=1))
        losses, gnorms = [], []
        for i in range(2):
            st, m = JT.train_step(jcfg, jvae, st, vp, img, label,
                                  jnp.asarray(LR, jnp.float32),
                                  jnp.asarray(WD, jnp.float32),
                                  jax.random.PRNGKey(i), label_smooth=0.1,
                                  dtype=jnp.float32, optimizer=opt)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        out[opt] = {"loss": np.array(losses), "grad_norm": np.array(gnorms),
                    "params": _flat_np(jax.tree.map(np.asarray, st.params), ""),
                    "grads": _flat_np(jax.tree.map(np.asarray, grads), "")}
    return out


def _port_refs(var_cfg, state, inp):
    """The first step's gradients and two factored-RMS train_steps of the
    port on one process."""
    vae_cfg, vae = VQVAEConfig(**VAE_KW), _vae()
    img, label = torch.from_numpy(inp["img"]), torch.from_numpy(inp["label"])
    leaves = T.tree_map(lambda t: t.detach().requires_grad_(), state.params)
    _, gt, x_in = T.tokenize(var_cfg, vae_cfg, vae, img)
    loss, _ = T.loss_and_metrics(var_cfg, leaves, label, x_in, gt, None, 0.1,
                                 dtype=F32)
    it = iter(torch.autograd.grad(loss, [t for _, t in T.tree_leaves(leaves)]))
    grads = T.tree_map(lambda _: next(it), leaves)
    losses, gnorms = [], []
    for _ in range(2):
        state, m = T.train_step(var_cfg, vae_cfg, state, vae, img, label, LR, WD,
                                None, label_smooth=0.1, dtype=F32,
                                optimizer="adafactor")
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return {"loss": np.array(losses), "grad_norm": np.array(gnorms),
            "params": {k.lstrip("/"): v for k, v in _flat(state.params).items()},
            "grads": {k.lstrip("/"): v for k, v in _flat(grads).items()}}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _flat_np(tree, prefix):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_np(v, f"{prefix}/{k}" if prefix else k))
    else:
        out[prefix] = np.asarray(tree)
    return out


def _optax_tree(opt_state, opt):
    """optax's chained state as the port's converter reads it."""
    inner = opt_state[1]
    names = ("mu", "nu") if opt == "adamw" else ("v_row", "v_col", "v")
    tree = {n: getattr(inner, n) for n in names}
    tree["count"] = inner.count
    return tree


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Make the inputs and the single-device checkpoint the resume jobs
    start from, run the two- and four-rank jobs, and return (out dir,
    inputs, {job name: [rank results]})."""
    from tests.mp_common import multiprocess_launch_lock

    from sdvar_tpu_torch.train.pretokenize import (
        build_token_datasets_for_passes,
        pretokenize_dataset,
    )

    out = str(tmp_path_factory.mktemp("torch_train_mesh"))
    vae_cfg = VQVAEConfig(**VAE_KW)
    inp = {}
    inp["img"] = np.random.default_rng(0).uniform(-1, 1, (4, 3, 48, 48)
                                                  ).astype(np.float32)
    inp["label"] = np.array([0, 3, 5, 9], np.int32)
    refs = _jax_refs(inp)
    sets = build_token_datasets_for_passes(None, 48, passes=1, seed=0,
                                           synthetic_len=16)
    pretokenize_dataset(vae_cfg, init_vqvae_params(vae_cfg, seed=0, device="cpu"),
                        sets, os.path.join(out, "tokens"), batch=4,
                        shard_size=8, log_every=0)
    _single("tiny", os.path.join(out, "resume_from"), 1, iters=2)
    for tag in ("1x2", "2x1"):
        shutil.copytree(os.path.join(out, "resume_from"),
                        os.path.join(out, f"resume_{tag}"))
    np.savez(os.path.join(out, "inputs.npz"), **inp)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SDVAR_", "JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    with multiprocess_launch_lock():
        for world in (2, 4):
            launch([sys.executable, os.path.abspath(__file__), out],
                   world=world, timeout=600, env=env, cwd=REPO)
    res = {}
    for world, job in _jobs():
        res[job["name"]] = [dict(np.load(os.path.join(
            out, f"{job['name']}_rank{r}.npz"))) for r in range(world)]
    return out, refs, res


@pytest.fixture(scope="module")
def singles(ranks):
    """The single-device references of the run jobs."""
    out = ranks[0]
    ref = {}
    for data in (1, 2):
        ref[("tiny", data)] = _single("tiny", os.path.join(out, f"one_{data}"), data)
    ref[("tokens", 2)] = _single("tiny", os.path.join(out, "tok_2"), 2,
                                 tokens=os.path.join(out, "tokens"))
    ref[("six", 1)] = _single("six", os.path.join(out, "one_six"), 1)
    for data in (1, 2):  # step 3 on the batch the mesh reads there
        d = os.path.join(out, f"resume_one_{data}")
        shutil.copytree(os.path.join(out, "resume_from"), d)
        ref[("resume", data)] = _single("tiny", d, data, iters=3)
    return ref


def _close_losses(got, hist):
    """Losses and global gradient norms (the norm sees a missing or doubled
    share of a gradient, which the parameters after a few AdamW steps at
    the warm-up's learning rate do not)."""
    np.testing.assert_array_equal(got["it"], [h["it"] for h in hist])
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], [h[k] for h in hist], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def _close_params(got, state, tol=2e-4):
    flat = _flat(state.params, "/params")
    assert {k for k in got if k.startswith("w/params")} == {f"w{k}" for k in flat}
    for k, v in flat.items():
        np.testing.assert_allclose(got[f"w{k}"], v, rtol=tol, atol=tol, err_msg=k)


def _ranks_equal(rows):
    """The gathered trees (split leaves all-gathered, replicated leaves
    this rank's own) bit-equal across the ranks."""
    for r in rows[1:]:
        for k, v in rows[0].items():
            if k.startswith("w/"):
                np.testing.assert_array_equal(r[k], v, err_msg=k)


RUNS = [("run_1x2", "tiny", 1), ("run_2x1", "tiny", 2), ("run_2x2", "tiny", 2),
        ("tokens_2x1", "tokens", 2),
        ("run_six_1x4", "six", 1)]


@pytest.mark.parametrize("name,ref,data", RUNS)
def test_run_training_on_a_mesh_matches_one_device(ranks, singles, name, ref, data):
    state, hist = singles[(ref, data)]
    for got in ranks[2][name]:
        assert len(got["loss"]) == ITERS
        _close_losses(got, hist)
        _close_params(got, state)


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_replicated_leaves_bit_equal_across_ranks(ranks, name):
    _ranks_equal(ranks[2][name])


def test_indivisible_heads_stay_whole(ranks):
    """6 heads at model=4: every rank holds qkv whole (3 x 192 columns)."""
    for got in ranks[2]["run_six_1x4"]:
        assert int(got["local_qkv_cols"]) == 3 * 6 * 32
    for got in ranks[2]["run_2x2"]:
        assert int(got["local_qkv_cols"]) == 3 * 256 // 2


def _close_steps(rows, ref):
    for got in rows:
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                                   rtol=1e-4, atol=1e-4)
        for k, v in ref["params"].items():
            np.testing.assert_allclose(got[f"w/params/{k}"], v, rtol=2e-4,
                                       atol=2e-4, err_msg=k)
        for k, v in ref["grads"].items():  # each leaf within 1e-4 of its size
            err = np.abs(got[f"g/{k}"].astype(np.float64) - v).max()
            assert err <= 1e-4 * np.abs(v).max(), (k, err, np.abs(v).max())
    _ranks_equal(rows)


@pytest.mark.parametrize("tag", ["1x2", "2x1"])
def test_train_step_on_a_mesh_matches_jax(ranks, tag):
    """AdamW from JAX's state against the JAX package's train_step."""
    _close_steps(ranks[2][f"jax_adamw_{tag}"], ranks[1]["adamw"])


@pytest.mark.parametrize("job", ["jax_adamw_1x2", "jax_adamw_2x1",
                                 "jax_adafactor_1x2", "jax_adafactor_2x1",
                                 "vae_2x1"])
def test_mesh_steps_keep_the_state_storage(ranks, job):
    """Each rank's train_step (the gradients averaged into themselves over
    "data" on 2x1) and vae_train_step write the new state into the
    state's own tensors: every leaf keeps its storage over two steps."""
    for got in ranks[2][job]:
        assert bool(got["kept_storage"])


@pytest.mark.parametrize("tag", ["1x2", "2x1"])
def test_factored_optimizer_on_a_mesh_matches_one_device(ranks, tag):
    """The factored RMS with split factored axes (qkv, fc1, 6C over their
    column moments; proj and fc2 over their row moments) against the same
    steps on one process."""
    _close_steps(ranks[2][f"jax_adafactor_{tag}"], ranks[1]["adafactor"])


@pytest.mark.parametrize("name", ["run_1x2", "run_2x1", "run_2x2"])
def test_mesh_checkpoint_loads_on_one_process(ranks, name):
    """The file rank 0 wrote is the whole tree: it loads into a
    single-device template equal bit for bit to the gathered state."""
    out, _, res = ranks
    var_cfg = VARConfig(**_var_kw("tiny"))
    from sdvar_tpu_torch.models.var import init_var_params

    template = T.init_train_state(init_var_params(var_cfg, seed=9, device="cpu"))
    loaded, meta = CK.auto_resume(os.path.join(out, name), template)
    assert loaded is not None and meta["step"] == ITERS == loaded.step
    flat = _flat(_state_tree(loaded))
    for k, v in flat.items():
        np.testing.assert_array_equal(res[name][0][f"w{k}"], v, err_msg=k)


@pytest.mark.parametrize("tag", ["1x2", "2x1"])
def test_single_device_checkpoint_resumes_on_a_mesh(ranks, singles, tag):
    """A single-device checkpoint at step 2, resumed on the mesh for one
    more step, against the same resume on one device."""
    state, hist = singles[("resume", MESHES[tag][0])]
    for got in ranks[2][f"resume_{tag}"]:
        np.testing.assert_array_equal(got["it"], [3])
        _close_losses(got, hist)
        _close_params(got, state)


def test_sampler_partition_over_data_ranks():
    """Two data ranks read disjoint contiguous halves of one epoch-seeded
    permutation, which cover the dataset (the reference sampler)."""
    N, GB, W = 100, 8, 2
    per_epoch = []
    for rank in range(W):
        s = DistInfiniteBatchSampler(N, GB, world_size=W, rank=rank, seed=3)
        it = iter(s)
        per_epoch.append([i for _ in range(s.iters_per_ep) for i in next(it)])
    total = ((N + GB - 1) // GB) * GB
    g = np.random.default_rng(3).permutation(N)
    np.testing.assert_array_equal(per_epoch[0] + per_epoch[1],
                                  np.concatenate([g, g[:total - N]]))


def test_sampler_resumes_mid_epoch():
    s = DistInfiniteBatchSampler(64, 8, world_size=2, rank=1, seed=7)
    it = iter(s)
    for _ in range(11):
        next(it)
    s2 = DistInfiniteBatchSampler(64, 8, world_size=2, rank=1, seed=7,
                                  start_ep=11 // 8, start_it=11 % 8)
    it2 = iter(s2)
    assert [next(it2) for _ in range(3)] == [next(it) for _ in range(3)]


@pytest.fixture(scope="module")
def vae_whole():
    """Two vae_train_steps of one process on the whole batch: per step the
    EMA tracker, the usage and the losses, then the parameters."""
    from sdvar_tpu_torch.train import vae_trainer as VT

    cfg = VQVAEConfig(**VAE_KW)
    st = VT.init_vae_train_state(cfg, _vae())
    img = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (4, 3, 48, 48)).astype(np.float32))
    steps = []
    for _ in range(VAE_STEPS):
        st, m = VT.vae_train_step(cfg, st, img, 1e-3)
        steps.append((st.ema_hits_SV.numpy().copy(), m["usage_per_scale"].numpy(),
                      np.array([float(m[k]) for k in VAE_LOSSES])))
    return steps, _flat(st.params)


def test_vae_hits_summed_over_data(ranks, vae_whole):
    """vae_train_step on each data rank's half of the batch: the EMA hit
    tracker and the usage are the whole batch's on one process, at both
    steps."""
    steps, _ = vae_whole
    for got in ranks[2]["vae_2x1"]:
        for i, (ema, usage, _) in enumerate(steps):
            np.testing.assert_array_equal(got[f"ema{i}"], ema)
            np.testing.assert_array_equal(got[f"usage{i}"], usage)


def test_vae_step_on_a_data_mesh_takes_the_whole_batch_step(ranks, vae_whole):
    """The gradients averaged over "data": after two steps the parameters
    are equal across the ranks and within 1e-5 (relative to each leaf's
    size) of one process stepping on the whole batch; the losses are the
    whole batch's means (1e-5)."""
    steps, params = vae_whole
    rows = ranks[2]["vae_2x1"]
    for got in rows:
        assert {k for k in got if k.startswith("p/")} == {f"p{k}" for k in params}
        for k, v in params.items():
            err = np.abs(got[f"p{k}"].astype(np.float64) - v).max()
            assert err <= 1e-5 * np.abs(v).max(), (k, err, np.abs(v).max())
        for i, (_, _, losses) in enumerate(steps):
            np.testing.assert_allclose(got[f"losses{i}"], losses, rtol=1e-5)
    for k in params:
        np.testing.assert_array_equal(rows[1][f"p{k}"], rows[0][f"p{k}"], err_msg=k)


def test_mesh_run_stopped_and_resumed_is_bit_equal_to_the_straight_run(ranks):
    """On 2x1: run_training stopped at step 2 and resumed to step 4 (the
    checkpoint gathered whole and cut again) against the run straight to
    step 4, every leaf of the parameters and the optimizer state, on both
    ranks; the draws of both keyed by the step."""
    for got in ranks[2]["stop_resume_2x1"]:
        np.testing.assert_array_equal(got["resumed_it"], [3, 4])
        np.testing.assert_array_equal(got["straight_it"], [1, 2, 3, 4])
        keys = [k for k in got if k.startswith("straight/")]
        assert len(keys) > 22
        for k in keys:
            np.testing.assert_array_equal(got["resumed" + k[len("straight"):]],
                                          got[k], err_msg=k)

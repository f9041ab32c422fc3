"""The port's trainer against the JAX package's, on a tiny VAR (depth 2,
V=64, scales 1-2-3) made by the JAX initialiser and a tiny VQVAE (ch=32,
Cvae=8; the codebook an ``eini=1.0`` draw) made by the port's (its
encoder is held against the JAX initialiser's weights in
``test_torch_encoder.py``), both packages on the same numpy weights, f32,
48px images, deterministic forward (cond drop and drop path 0: the
draws are held against JAX in ``test_torch_train_forward.py``).

Bounds: ``loss_and_metrics``' gradients within 1e-4 of each tensor's
max|g| (label smoothing 0.1) and its five metrics within 1e-5; two
``train_step``s from one state and batch: loss and grad_norm within 1e-5
relative, Adam's m and v (or the factored moments) within 1e-4 of each
tensor's size, parameters within 1e-6 absolute except a share of at most
0.1% of elements within 2 * lr * steps (where g is about 0, Adam's first
step may take either sign), the share printed. The same for Adafactor
(a width of 128, so that leaves are factored), ``grad_accum=2`` and a
progressive stage, and for one port step from a JAX state carried over
by ``train_state_from_jax``. The optimizer's arithmetic is also held
against optax on factored and unfactored shapes.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdvar_tpu.config import VARConfig as JVARConfig
from sdvar_tpu.config import VQVAEConfig as JVQVAEConfig
from sdvar_tpu.models import quantizer as JQ
from sdvar_tpu.models import var as JM
from sdvar_tpu.models import vqvae as JVQ
from sdvar_tpu.train import trainer as JT
from sdvar_tpu_torch.config import VARConfig, VQVAEConfig
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.train import trainer as T
from sdvar_tpu_torch.utils.from_jax import (
    train_state_from_jax,
    var_params_from_jax,
    vqvae_params_from_jax,
)

PNS = (1, 2, 3)
VAR_KW = dict(depth=2, num_classes=10, patch_nums=PNS, vocab_size=64, Cvae=8,
              head_dim=32, cond_drop_rate=0.0, drop_path_rate=0.0)
VAE_KW = dict(vocab_size=64, z_channels=8, ch=32, patch_nums=PNS)
LR, WD = 1e-4, 0.05
B = 4


def _rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, size = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * size, (err, size)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def models():
    jvae = JVQVAEConfig(**VAE_KW)
    vp = _numpy(VQ.init_vqvae_params(VQVAEConfig(**VAE_KW), seed=0,
                                     device="cpu", eini=1.0))
    img = np.random.default_rng(0).uniform(-1, 1, (B, 3, 48, 48)).astype(np.float32)
    label = np.array([0, 3, 5, 9], np.int32)
    return jvae, vp, vqvae_params_from_jax(vp, device="cpu"), img, label


@functools.lru_cache(maxsize=None)
def _var_np(head_dim):
    kw = dict(VAR_KW, head_dim=head_dim)
    return jax.tree.map(np.asarray, jax.jit(JM.init_var_params, static_argnums=0)(
        JVARConfig(**kw), jax.random.PRNGKey(1)))


def _var(head_dim=32, seed=1):
    kw = dict(VAR_KW, head_dim=head_dim)
    p = jax.tree.map(np.copy, _var_np(head_dim))
    rng = np.random.default_rng(seed)
    p["blocks"]["ada_lin_b"] = rng.normal(0, 0.3, p["blocks"]["ada_lin_b"].shape
                                          ).astype(np.float32)
    return JVARConfig(**kw), VARConfig(**kw), p


def test_decay_mask_matches_jax():
    _, _, p = _var()
    want = _flat(JT.decay_mask(p))
    got = _flat(T.decay_mask(var_params_from_jax(p, device="cpu")))
    assert got == want


def test_loss_and_metrics_gradients_match_jax(models):
    jvae, vp, tvp, img, label = models
    jcfg, cfg, p = _var()
    ids = jax.jit(JVQ.img_to_idxBl, static_argnums=0)(jvae, vp, jnp.asarray(img))
    gt = jnp.concatenate(ids, axis=1)
    x_in = JQ.idx_to_var_input(jvae, vp["quant"], ids)

    def jloss(params):
        return JT.loss_and_metrics(jcfg, params, jnp.asarray(label), x_in, gt,
                                   None, 0.1, dtype=jnp.float32)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(p)
    tp = {k: v for k, v in var_params_from_jax(p, device="cpu").items()}
    leaves = T.tree_map(lambda t: t.requires_grad_(), tp)
    _, t_gt, t_x = T.tokenize(cfg, VQVAEConfig(**VAE_KW), tvp,
                              torch.from_numpy(img))
    np.testing.assert_array_equal(t_gt.numpy(), np.asarray(gt))
    _rel(t_x, x_in, 1e-5)
    loss, metrics = T.loss_and_metrics(cfg, leaves, torch.from_numpy(label),
                                       t_x, t_gt, None, 0.1,
                                       dtype=torch.float32)
    grads = torch.autograd.grad(loss, [t for _, t in T.tree_leaves(leaves)])
    _rel(loss.detach(), jl, 1e-5)
    for k in T.METRICS:
        assert abs(float(metrics[k]) - float(jm[k])) <= 1e-5 * max(
            1.0, abs(float(jm[k]))), (k, float(metrics[k]), float(jm[k]))
    jflat = _flat(jg)
    for (path, _), g in zip(T.tree_leaves(leaves), grads):
        _rel(g, jflat["/" + path], 1e-4)


def _jax_steps(jcfg, jvae, p, vp, img, label, n, optimizer="adamw", **kw):
    st = JT.init_train_state(jax.tree.map(jnp.asarray, p), optimizer=optimizer)
    out = []
    for i in range(n):
        st, m = JT.train_step(jcfg, jvae, st, vp, jnp.asarray(img),
                              jnp.asarray(label), jnp.asarray(LR, jnp.float32),
                              jnp.asarray(WD, jnp.float32),
                              jax.random.PRNGKey(i), label_smooth=0.1,
                              dtype=jnp.float32, optimizer=optimizer, **kw)
        out.append((jax.tree.map(np.asarray, st), jax.tree.map(float, m)))
    return out


def _copy(state):
    """A copy of a train state: a step consumes the one it is given."""
    return T.TrainState(T.tree_map(torch.clone, state.params),
                        T.tree_map(torch.clone, state.opt_state), state.step)


def _port_steps(cfg, tvp, state, img, label, n, optimizer="adamw", **kw):
    """n steps from ``state`` (consumed), a copy of each step's state."""
    out = []
    for _ in range(n):
        state, m = T.train_step(cfg, VQVAEConfig(**VAE_KW), state, tvp,
                                torch.from_numpy(img), torch.from_numpy(label),
                                LR, WD, None, label_smooth=0.1,
                                dtype=torch.float32, optimizer=optimizer, **kw)
        out.append((_copy(state), {k: float(v) for k, v in m.items()}))
    return out


def _check_step(port, jst, jm, steps, optimizer):
    state, m = port
    for k in ("loss", "grad_norm"):
        assert abs(m[k] - jm[k]) <= 1e-5 * abs(jm[k]), (k, m[k], jm[k])
    inner = jst.opt_state[1]
    names = ("mu", "nu") if optimizer == "adamw" else ("v_row", "v_col", "v")
    for n in names:
        jflat = _flat(getattr(inner, n))
        for path, t in T.tree_leaves(state.opt_state[n]):
            _rel(t.detach(), jflat["/" + path], 1e-4)
    assert int(state.opt_state["count"]) == int(inner.count) == steps
    assert state.step == int(jst.step) == steps
    jflat = _flat(jst.params)
    diff_n = total = 0
    for path, t in T.tree_leaves(state.params):
        d = np.abs(t.numpy().astype(np.float64) - jflat["/" + path])
        assert d.max() <= 2 * LR * steps + 1e-6, (path, d.max())
        diff_n += int((d > 1e-6).sum())
        total += d.size
    share = diff_n / total
    print(f"{optimizer} step {steps}: share of parameter elements beyond "
          f"1e-6 of JAX's {share:.6f}")
    assert share <= 1e-3, share


@pytest.mark.parametrize("case", ["adamw", "adafactor", "grad_accum",
                                  "prog_si"])
def test_train_steps_match_jax(models, case):
    jvae, vp, tvp, img, label = models
    optimizer = "adafactor" if case == "adafactor" else "adamw"
    jcfg, cfg, p = _var(head_dim=64 if case == "adafactor" else 32)
    kw = {"grad_accum": {"grad_accum": 2},
          "prog_si": {"prog_si": 1, "prog_wp": 0.5}}.get(case, {})
    jout = _jax_steps(jcfg, jvae, p, vp, img, label, 2, optimizer,
                      **{k: (jnp.asarray(v, jnp.float32) if k == "prog_wp"
                             else v) for k, v in kw.items()})
    state = T.init_train_state(var_params_from_jax(p, device="cpu"), optimizer)
    if optimizer == "adafactor":
        assert any(v.numel() > 1 for _, v in T.tree_leaves(state.opt_state["v_row"]))
    pout = _port_steps(cfg, tvp, state, img, label, 2, optimizer, **kw)
    for i in range(2):
        _check_step(pout[i], jout[i][0], jout[i][1], i + 1, optimizer)


def test_grad_accum_matches_the_full_batch(models):
    _, _, tvp, img, label = models
    _, cfg, p = _var()
    state = T.init_train_state(var_params_from_jax(p, device="cpu"))
    full = _port_steps(cfg, tvp, _copy(state), img, label, 1)[0]
    acc = _port_steps(cfg, tvp, state, img, label, 1, grad_accum=2)[0]
    assert abs(full[1]["loss"] - acc[1]["loss"]) <= 1e-5 * full[1]["loss"]
    for (path, a), (_, b) in zip(T.tree_leaves(acc[0].opt_state["mu"]),
                                 T.tree_leaves(full[0].opt_state["mu"])):
        _rel(a, b, 1e-4)


def test_train_state_bridge_continues_the_jax_run(models):
    """One JAX step, carried over, one port step == JAX's second step."""
    jvae, vp, tvp, img, label = models
    for optimizer, hd in (("adamw", 32), ("adafactor", 64)):
        jcfg, cfg, p = _var(head_dim=hd)
        (s1, _), (s2, m2) = _jax_steps(jcfg, jvae, p, vp, img, label, 2,
                                       optimizer)
        state = train_state_from_jax(s1, device="cpu")
        assert state.step == 1
        got = _port_steps(cfg, tvp, state, img, label, 1, optimizer)[0]
        _check_step(got, s2, m2, 2, optimizer)


def test_optimizer_matches_optax_on_factored_shapes():
    rng = np.random.default_rng(5)
    shapes = {"a": (2, 160, 384), "b": (130,), "c": (200, 129), "d": (3, 4),
              "e": (128, 64)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 0.5).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    for kind in ("adamw", "adafactor"):
        tx = JT.make_optimizer(2.0, kind)
        jst = tx.init(params)
        tst = T.init_opt_state({k: torch.from_numpy(v) for k, v in params.items()},
                               kind)
        for g in grads:
            ju, jst = tx.update(g, jst, params)
            tg = {k: torch.from_numpy(v) for k, v in g.items()}
            # the update of zero parameters at lr 1 and no decay is -u
            tp = {k: torch.zeros(s) for k, s in shapes.items()}
            T.apply_optimizer(tp, tg, tst, 1.0, 0.0, clip=2.0, kind=kind,
                              norm=T.global_norm(tg))
            for k in shapes:
                _rel(-tp[k], ju[k], 1e-5)
        assert int(tst["count"]) == 3


def test_eval_step_matches_jax(models):
    jvae, vp, tvp, img, label = models
    jcfg, cfg, p = _var()
    want = JT.eval_step(jcfg, jvae, p, vp, jnp.asarray(img),
                        jnp.asarray(label), dtype=jnp.float32)
    got = T.eval_step(cfg, VQVAEConfig(**VAE_KW), var_params_from_jax(p, "cpu"),
                      tvp, torch.from_numpy(img), torch.from_numpy(label),
                      dtype=torch.float32)
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * max(
            1.0, abs(float(want[k]))), k

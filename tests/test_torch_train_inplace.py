"""The training steps update their state in place, as the JAX steps write
their donated state: ``train_step`` (AdamW and the factored RMS, the clip
binding and not, ``grad_accum`` 1 and 2), ``vae_train_step`` and
``tools/bench_train``'s SGD step keep every leaf of their state in its
own storage, and their new state is bit-equal to the out-of-place
formulas of ``tests/optim_reference.py`` on the same gradients. The
optimizer works through a stacked leaf in pieces along its first axis
(``trainer.OPT_PIECE``): here the pieces are cut to one slice of that
axis, and the update is bit-equal to the whole-leaf one on factored and
unfactored shapes, a factored axis first among them.

A tiny VAR (depth 2, head_dim 64: C=128, so the block weights factor; 48px,
V=64), f32, a deterministic forward, one intra-op thread (the reference
and the step then sum the same gradients in the same order).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import optim_reference as R  # noqa: E402

from sdvar_tpu_torch.config import VARConfig, VQVAEConfig  # noqa: E402
from sdvar_tpu_torch.models.var import init_var_params  # noqa: E402
from sdvar_tpu_torch.models.vqvae import init_vqvae_params  # noqa: E402
from sdvar_tpu_torch.tools import bench_train  # noqa: E402
from sdvar_tpu_torch.train import trainer as T  # noqa: E402
from sdvar_tpu_torch.train import vae_trainer as VT  # noqa: E402

PNS = (1, 2, 3)
VAR_KW = dict(depth=2, num_classes=10, patch_nums=PNS, vocab_size=64, Cvae=8,
              head_dim=64, cond_drop_rate=0.0, drop_path_rate=0.0)
VAE_KW = dict(vocab_size=64, z_channels=8, ch=32, patch_nums=PNS)
LR, WD = 1e-3, 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_slice(monkeypatch):
    """Pieces of one slice of a leaf's first axis."""
    monkeypatch.setattr(T, "OPT_PIECE", 1)


@pytest.fixture(scope="module")
def stack():
    cfg, vae_cfg = VARConfig(**VAR_KW), VQVAEConfig(**VAE_KW)
    p = init_var_params(cfg, seed=3, device="cpu")
    p["blocks"]["ada_lin_b"].normal_(0, 0.3,
                                     generator=torch.Generator().manual_seed(6))
    vae = init_vqvae_params(vae_cfg, seed=4, device="cpu", eini=1.0)
    img = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (4, 3, 48, 48)).astype(np.float32))
    return cfg, vae_cfg, p, vae, img, torch.tensor([0, 3, 5, 9])


def _clone(tree):
    return T.tree_map(torch.clone, tree)


def _ptrs(tree):
    return {path: t.data_ptr() for path, t in T.tree_leaves(tree)}


def _assert_equal(got, want):
    want = dict(T.tree_leaves(want))
    for path, t in T.tree_leaves(got):
        assert torch.equal(t, want[path]), path


def _reference_grads(cfg, vae_cfg, params, vae, img, label, grad_accum):
    """train_step's gradients and loss, recomputed on a copy of the
    parameters (the same forward, one thread: the same bits)."""
    leaves = T.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    flat = [t for _, t in T.tree_leaves(leaves)]
    mb = img.shape[0] // grad_accum
    micro, losses = [], []
    for i in range(grad_accum):
        sl = slice(i * mb, (i + 1) * mb)
        _, gt, x_in = T.tokenize(cfg, vae_cfg, vae, img[sl])
        loss, _ = T.loss_and_metrics(cfg, leaves, label[sl], x_in, gt, None,
                                     0.1, dtype=torch.float32)
        micro.append(T._grad(loss, flat))
        losses.append(loss.detach())
    it = iter(R.accumulate(micro))
    return T.tree_map(lambda _: next(it), params), losses


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("clip", ["binding", "free"])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_train_step_updates_its_state_in_place(stack, one_slice, kind, clip,
                                               grad_accum):
    cfg, vae_cfg, p, vae, img, label = stack
    state = T.init_train_state(_clone(p), kind)
    # one step first, so that the moments and the count are not zeros
    state, _ = T.train_step(cfg, vae_cfg, state, vae, img, label, LR, WD,
                            None, label_smooth=0.1, dtype=torch.float32,
                            optimizer=kind)
    grads, _ = _reference_grads(cfg, vae_cfg, state.params, vae, img, label,
                                grad_accum)
    norm = T.global_norm(grads)
    max_norm = float(norm) * (0.5 if clip == "binding" else 2.0)
    want_p, want_o = R.apply_optimizer(_clone(state.params), grads,
                                       _clone(state.opt_state), LR, WD,
                                       max_norm, kind)
    ptrs = _ptrs({"params": state.params, "opt_state": state.opt_state})
    got, m = T.train_step(cfg, vae_cfg, state, vae, img, label, LR, WD, None,
                          clip=max_norm, label_smooth=0.1,
                          grad_accum=grad_accum, dtype=torch.float32,
                          optimizer=kind)
    assert _ptrs({"params": got.params, "opt_state": got.opt_state}) == ptrs
    assert got.step == 2
    assert torch.equal(m["grad_norm"], norm)
    _assert_equal(got.params, want_p)
    _assert_equal(got.opt_state, want_o)
    assert int(got.opt_state["count"]) == 2


SHAPES = {"stacked": (3, 160, 384), "stacked_rows": (3, 384, 160),
          "bias": (130,), "rows_first": (200, 129), "rows_first_3d": (200, 3, 129),
          "small": (3, 4), "wide": (128, 64), "stacked_bias": (4, 130)}


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_pieces_are_bit_equal_to_the_whole_leaf(monkeypatch, kind):
    """apply_optimizer three times on one slice at a time and on whole
    leaves, against the out-of-place reference: the same bits, and the
    state in its own storage. ``stacked`` and ``stacked_rows``: the
    factored axes leave out the first, the one the pieces cut, in either
    order; ``rows_first`` and ``rows_first_3d``: the factored RMS reduces
    over the axis the pieces cut."""
    rng = np.random.default_rng(5)
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in SHAPES.items()}
    grads = [{k: torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32))
              for k, s in SHAPES.items()} for _ in range(3)]
    assert T._factored_dims(SHAPES["rows_first"]) == (1, 0)
    assert T._factored_dims(SHAPES["rows_first_3d"]) == (2, 0)
    assert T._factored_dims(SHAPES["stacked"]) == (1, 2)
    assert T._factored_dims(SHAPES["stacked_rows"]) == (2, 1)
    runs = {}
    for piece in (1, 1 << 30):
        monkeypatch.setattr(T, "OPT_PIECE", piece)
        p, o = _clone(params), T.init_opt_state(_clone(params), kind)
        if piece == 1:
            assert len(T._pieces(p["stacked"])) == 3
        ptrs = _ptrs({"p": p, "o": o})
        for g in grads:
            out = T.apply_optimizer(p, _clone(g), o, LR, WD, clip=2.0, kind=kind,
                                    norm=T.global_norm(g))
            assert out[0] is p and out[1] is o
        assert _ptrs({"p": p, "o": o}) == ptrs
        runs[piece] = (p, o)
    want_p, want_o = params, T.init_opt_state(_clone(params), kind)
    for g in grads:
        want_p, want_o = R.apply_optimizer(want_p, g, want_o, LR, WD, 2.0, kind)
    for p, o in runs.values():
        _assert_equal(p, want_p)
        _assert_equal(o, want_o)


def test_factored_means_of_pieces_on_the_cpu(one_slice):
    """``tools/probe_factored_pieces`` on the CPU: one slice at a time, the
    row and column means of a stacked leaf (its factored axes leave out
    the first) keep the whole leaf's bits here, over the strided axis too
    (on the card the strided one does not, so the optimizer takes them
    over the whole leaf)."""
    from sdvar_tpu_torch.tools import probe_factored_pieces as P

    out = P.run("cpu", {"stacked": (3, 160, 384), "stacked_rows": (3, 384, 160)})
    assert sorted(out) == [("stacked", 1), ("stacked", 2),
                           ("stacked_rows", 1), ("stacked_rows", 2)]
    assert all(r[0] == 0 and r[2] == 0.0 for r in out.values())


def test_clip_scales_the_gradients_in_place(one_slice):
    g = {"a": torch.randn(3, 5, 7, generator=torch.Generator().manual_seed(1)),
         "b": torch.randn(9, generator=torch.Generator().manual_seed(2))}
    norm = T.global_norm(g)
    want = R.clip_by_global_norm(_clone(g), 0.5, norm)
    ptrs = _ptrs(g)
    assert T.clip_by_global_norm(g, 0.5, norm) is g
    assert _ptrs(g) == ptrs
    _assert_equal(g, want)


def test_vae_train_step_updates_its_state_in_place():
    cfg = VQVAEConfig(**VAE_KW)
    st = VT.init_vae_train_state(cfg, init_vqvae_params(cfg, seed=0, device="cpu",
                                                        eini=1.0))
    img = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2, 3, 48, 48)).astype(np.float32))
    for i in range(2):
        leaves = T.tree_map(lambda t: t.detach().clone().requires_grad_(),
                            st.params)
        flat = [t for _, t in T.tree_leaves(leaves)]
        loss, (hits, _) = VT.vae_loss(cfg, leaves, img)
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
        want_p = R.sgd(_clone(st.params), grads,
                       torch.tensor(1e-3, dtype=torch.float32))
        from sdvar_tpu_torch.models import quantizer as Q
        want_ema = Q.update_vocab_hit_ema(st.ema_hits_SV.clone(),
                                          hits.detach(), st.step)
        ptrs = _ptrs({"p": st.params, "ema": st.ema_hits_SV})
        st, m = VT.vae_train_step(cfg, st, img, 1e-3)
        assert _ptrs({"p": st.params, "ema": st.ema_hits_SV}) == ptrs
        assert st.step == i + 1 and torch.equal(m["loss"], loss.detach())
        _assert_equal(st.params, want_p)
        assert torch.equal(st.ema_hits_SV, want_ema)


def test_bench_train_sgd_step_updates_its_parameters_in_place(stack):
    cfg, vae_cfg, p, vae, img, label = stack
    params = _clone(p)
    step = bench_train._sgd_step(cfg, vae_cfg, vae, False, False, False,
                                 lr=1e-3)
    gen = T.step_generator(0, 0, "cpu")
    leaves = T.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    _, gt, x_in = T.tokenize(cfg, vae_cfg, vae, img)
    loss, _ = T.loss_and_metrics(cfg, leaves, label, x_in, gt,
                                 T.step_generator(0, 0, "cpu"), 0.0,
                                 dtype=torch.bfloat16)
    grads = torch.autograd.grad(loss, [t for _, t in T.tree_leaves(leaves)],
                                allow_unused=True, materialize_grads=True)
    want = R.sgd(_clone(params), grads, 1e-3)
    ptrs = _ptrs(params)
    got, got_loss = step(params, img, label, gen)
    assert got is params and _ptrs(got) == ptrs
    assert torch.equal(got_loss, loss.detach())
    _assert_equal(got, want)


def test_owned_grads_clones_only_shared_or_strided_memory():
    """An expanded gradient, a second reference to one tensor and a view
    into a buffer another gradient already uses are cloned; an ordinary
    gradient (and a contiguous view of a buffer of its own) is kept."""
    own = torch.randn(4, 3)
    buf = torch.randn(10)
    expanded = torch.randn(3).expand(4, 3)
    grads = [own, own, expanded, buf[:5], buf[5:]]
    out = T.owned_grads(grads)
    assert out[0] is own and out[3] is grads[3]
    assert out[1] is not own and torch.equal(out[1], own)
    assert out[2].is_contiguous() and torch.equal(out[2], expanded)
    assert out[4].untyped_storage().data_ptr() != buf.untyped_storage().data_ptr()
    assert torch.equal(out[4], buf[5:])
    ptrs = [g.untyped_storage().data_ptr() for g in out]
    assert len(set(ptrs)) == len(ptrs)

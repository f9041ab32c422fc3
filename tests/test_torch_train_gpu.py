"""The training path on the card (marked ``gpu``; skipped where there is no
card): the attention Function (the kernel's forward, the ported backward)
against autograd through ``attention_plain`` on the card, and one f32
training step of a tiny stack on the card against the same step on the
CPU. Torch only, so that they run where JAX is absent:
    python -m pytest tests/test_torch_train_gpu.py -q -m gpu -o addopts="" --noconftest
"""

import numpy as np
import pytest
import torch

from sdvar_tpu_torch.config import VARConfig, VQVAEConfig
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.ops import attention as A
from sdvar_tpu_torch.ops.kernels.attention import attention_kernel, attention_plain
from sdvar_tpu_torch.ops.masks import block_causal_bias
from sdvar_tpu_torch.train import trainer as T

pytestmark = pytest.mark.gpu
PNS = (1, 2, 3)


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [0, 64])
def test_attention_function_matches_plain_autograd(cuda, dtype, chunk):
    """Strided q/k/v views of one fused projection, the block-causal bias
    of scales 1-6, one kernel launch a forward. The whole-tensor backward
    (chunk 0) is ``attention_composition``'s VJP: dq/dk/dv within 1e-3 of
    their size of autograd through it. The chunked backward keeps the
    probabilities in f32, as ``attention_plain`` does: within 1e-3 of
    autograd through that in f32; in bf16 (the gradients are bf16 tensors,
    summed in another order) at most one bf16 rounding beyond 1e-3 of
    their size, element by element."""
    g = torch.Generator(device=cuda).manual_seed(0)
    Bq, H, hd = 4, 4, 64
    bias = torch.from_numpy(block_causal_bias(PNS + (4, 5, 6))).to(cuda)
    L = bias.shape[0]
    qkv = torch.randn(Bq, L, 3, H, hd, device=cuda, generator=g).to(dtype)
    go = torch.randn(Bq, L, H, hd, device=cuda, generator=g).to(dtype)
    ref_fn = A.attention_composition if chunk == 0 else attention_plain
    grads = []
    A.set_attention_bwd_chunk(chunk)
    try:
        for fn in ("function", "reference"):
            x = qkv.detach().requires_grad_()
            q, k, v = x.unbind(2)
            n0 = attention_kernel.launches
            if fn == "function":
                out = A.attention(q, k, v, bias, 0.125)
                assert attention_kernel.launches == n0 + 1
            else:
                out = ref_fn(q, k, v, bias, 0.125)
            grads.append(torch.autograd.grad(out, x, go)[0])
    finally:
        A.set_attention_bwd_chunk(None)
    for i in range(3):
        got, want = grads[0][:, :, i].float(), grads[1][:, :, i].float()
        if chunk and dtype == torch.bfloat16:
            assert ((got - want).abs() <= want.abs() * 2.0 ** -7
                    + 1e-3 * want.abs().max()).all()
        else:
            assert _rel(got, want) <= 1e-3


def test_train_step_matches_the_cpu(cuda):
    """One f32 AdamW step of a tiny stack (depth 2, head_dim 32, 48px): the
    card's ids, loss, grad_norm and moments (within 1e-4 of their size)
    against the CPU's, and the attention kernel launched once a layer."""
    vc = VARConfig(depth=2, num_classes=10, patch_nums=PNS, vocab_size=64,
                   Cvae=8, head_dim=32, cond_drop_rate=0.0, drop_path_rate=0.0)
    qc = VQVAEConfig(vocab_size=64, z_channels=8, ch=32, patch_nums=PNS)
    p = init_var_params(vc, seed=3, device="cpu")
    p["blocks"]["ada_lin_b"].normal_(0, 0.3, generator=torch.Generator().manual_seed(6))
    vae = init_vqvae_params(qc, seed=4, device="cpu", eini=1.0)
    img = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (4, 3, 48, 48)).astype(np.float32))
    label = torch.tensor([0, 3, 5, 9])
    outs = []
    for d in ("cpu", cuda):
        state = T.init_train_state(T.tree_map(lambda t: t.to(d), p))
        v = T.tree_map(lambda t: t.to(d), vae)
        n0 = attention_kernel.launches
        state, m = T.train_step(vc, qc, state, v, img.to(d), label.to(d), 1e-4,
                                0.05, None, label_smooth=0.1, dtype=torch.float32)
        if d == cuda:
            assert attention_kernel.launches - n0 == vc.depth
        outs.append((T.tokenize(vc, qc, v, img.to(d))[1].cpu(), state,
                     {k: float(x) for k, x in m.items()}))
    (ic, sc, mc), (ig, sg, mg) = outs
    assert torch.equal(ic, ig)
    for k in ("loss", "grad_norm"):
        assert abs(mg[k] - mc[k]) <= 1e-5 * abs(mc[k]), (k, mg[k], mc[k])
    for name in ("mu", "nu"):
        for (_, a), (_, b) in zip(T.tree_leaves(sg.opt_state[name]),
                                  T.tree_leaves(sc.opt_state[name])):
            assert _rel(a.cpu(), b) <= 1e-4


def test_autograd_collectives_at_one_rank_equal_no_mesh(cuda):
    """A one-rank mesh registered: the collectives with gradients hand back
    their inputs, and an f32 train_step on the card (the mesh layout, the
    sharded optimizer's paths, the spans) gives the bits of the same step
    with no mesh, with the same row-1 launches."""
    from sdvar_tpu_torch.ops import partition as PT
    from sdvar_tpu_torch.parallel.mesh import single_device_mesh
    from sdvar_tpu_torch.utils.profiling import SpanTimer

    vc = VARConfig(depth=2, num_classes=10, patch_nums=PNS, vocab_size=64,
                   Cvae=8, head_dim=32, cond_drop_rate=0.0, drop_path_rate=0.0)
    qc = VQVAEConfig(vocab_size=64, z_channels=8, ch=32, patch_nums=PNS)
    p = T.tree_map(lambda t: t.to(cuda), init_var_params(vc, seed=3, device="cpu"))
    vae = T.tree_map(lambda t: t.to(cuda),
                     init_vqvae_params(qc, seed=4, device="cpu", eini=1.0))
    img = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (4, 3, 48, 48)).astype(np.float32)).to(cuda)
    label = torch.tensor([0, 3, 5, 9], device=cuda)
    x = torch.randn(4, 8, device=cuda, requires_grad=True)
    outs = []
    for mesh in (None, single_device_mesh()):
        PT.set_tp_mesh(mesh)
        try:
            assert PT.copy_to_model(x, 8) is x
            assert PT.reduce_from_model(x, 8) is x
            assert PT.gather_from_model(x, 8) is x
            n0 = attention_kernel.launches
            timer = SpanTimer(cuda)
            state, m = T.train_step(vc, qc, T.init_train_state(p), vae, img,
                                    label, 1e-4, 0.05, None, label_smooth=0.1,
                                    dtype=torch.float32, timer=timer)
            outs.append((state, float(m["loss"]), attention_kernel.launches - n0,
                         set(timer.report())))
        finally:
            PT.set_tp_mesh(None)
    (s0, l0, n0, spans0), (s1, l1, n1, spans1) = outs
    assert l0 == l1 and n0 == n1 == vc.depth
    assert spans0 == spans1 == {"tokenize", "forward", "backward", "optimizer"}
    for (_, a), (_, b) in zip(T.tree_leaves(s0.params), T.tree_leaves(s1.params)):
        assert torch.equal(a, b)

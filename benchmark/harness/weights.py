"""The cell's weights, made on the card from the run's seed by the
benchmark itself and handed to the port and to the reference alike.

No trained checkpoint is in the repository, so the weights are random.
They are drawn so that the model does real work: every block's AdaLN gamma
is of order 0.5 (the initialiser's 1e-5 would leave the blocks out of the
output), the class embedding conditions the modulations, and the head
gives logits with a standard deviation of about 2, so that top-k / top-p
sampling is peaked and a token's logit gap means something. The
configuration file records these choices under ``assumed``.

VAR: one normal draw a leaf (stacked over the layers), in the dtype the
cell serves or trains in. VQVAE: one uniform draw for all its convolution
weights and biases, cut into leaves, plus the codebook; f32, as the port
keeps it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_MASK63 = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for sub-stream ``stream`` of ``seed``."""
    mixed = (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) & _MASK63
    return torch.Generator(device=device).manual_seed(mixed)


def var_params(var: Dict, seed: int, device, dtype) -> Dict:
    """VAR parameters in the port's layout (the JAX package's: per-layer
    leaves stacked on a leading depth axis, linear weights as (in, out))."""
    g = generator(seed, 1, device)
    C, depth, H = var["embed_dim"], var["depth"], var["num_heads"]
    hidden, V, Cv = var["mlp_hidden"], var["vocab_size"], var["Cvae"]
    pns = var["patch_nums"]
    L, S = sum(p * p for p in pns), len(pns)

    def normal(shape, std):
        x = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return x.mul_(std)

    trunk = math.sqrt(1.0 / (3 * C))
    out_div = math.sqrt(2 * depth)
    ada_b = normal((depth, 6 * C), 1.0)
    ada_b[:, : 2 * C] *= 0.5   # gammas
    ada_b[:, 2 * C:] *= 0.1    # scales and shifts
    blocks = {
        "qkv_w": normal((depth, C, 3 * C), trunk),
        "q_bias": normal((depth, C), 0.02),
        "v_bias": normal((depth, C), 0.02),
        "proj_w": normal((depth, C, C), trunk / out_div),
        "proj_b": normal((depth, C), 0.02),
        "fc1_w": normal((depth, C, hidden), trunk),
        "fc1_b": normal((depth, hidden), 0.02),
        "fc2_w": normal((depth, hidden, C), math.sqrt(1.0 / (3 * hidden)) / out_div),
        "fc2_b": normal((depth, C), 0.02),
        "scale_mul": torch.full((depth, H), math.log(4.0), device=device,
                                dtype=dtype),
        "ada_lin_w": normal((depth, C, 6 * C), trunk),
        "ada_lin_b": ada_b,
    }
    return {
        "word_embed": {"w": normal((Cv, C), math.sqrt(1.0 / (3 * Cv))),
                       "b": normal((C,), 0.02)},
        "class_emb": normal((var["num_classes"] + 1, C), 0.5),
        "pos_start": normal((pns[0] ** 2, C), trunk),
        "pos_1LC": normal((L, C), trunk),
        "lvl_embed": normal((S, C), trunk),
        "blocks": blocks,
        "head_nm": {"w": normal((C, 2 * C), 0.5 * trunk),
                    "b": normal((2 * C,), 0.02)},
        "head": {"w": normal((C, V), 2.0 / math.sqrt(C)),
                 "b": normal((V,), 0.02)},
    }


def vqvae_layout(q: Dict) -> Dict:
    """The port's VQVAE tree as shapes: ("conv", (O, I, k, k)) for a conv,
    ("gn", C) for a GroupNorm; the quantizer apart."""
    ch, zc, mult, nrb = q["ch"], q["z_channels"], q["ch_mult"], q["num_res_blocks"]
    nres = len(mult)

    def conv(cin, cout, ks):
        return ("conv", (cout, cin, ks, ks))

    def res(cin, cout):
        p = {"norm1": ("gn", cin), "conv1": conv(cin, cout, 3),
             "norm2": ("gn", cout), "conv2": conv(cout, cout, 3)}
        if cin != cout:
            p["nin_shortcut"] = conv(cin, cout, 1)
        return p

    def attn(c):
        return {"norm": ("gn", c), "qkv": conv(c, 3 * c, 1),
                "proj_out": conv(c, c, 1)}

    in_mult = (1,) + tuple(mult)
    down = []
    for i in range(nres):
        cin, cout = ch * in_mult[i], ch * mult[i]
        blocks, attns, c = [], [], cin
        for _ in range(nrb):
            blocks.append(res(c, cout))
            c = cout
            if i == nres - 1 and q["using_sa"]:
                attns.append(attn(c))
        lvl = {"block": blocks, "attn": attns}
        if i != nres - 1:
            lvl["downsample"] = conv(c, c, 3)
        down.append(lvl)
    cmid = ch * mult[-1]
    mid = {"block_1": res(cmid, cmid), "attn_1": attn(cmid),
           "block_2": res(cmid, cmid)}
    encoder = {"conv_in": conv(3, ch, 3), "down": down, "mid": mid,
               "norm_out": ("gn", cmid), "conv_out": conv(cmid, zc, 3)}
    up, c = [None] * nres, cmid
    for i in reversed(range(nres)):
        cout = ch * mult[i]
        blocks, attns = [], []
        for _ in range(nrb + 1):
            blocks.append(res(c, cout))
            c = cout
            if i == nres - 1 and q["using_sa"]:
                attns.append(attn(c))
        lvl = {"block": blocks, "attn": attns}
        if i != 0:
            lvl["upsample"] = conv(c, c, 3)
        up[i] = lvl
    decoder = {"conv_in": conv(zc, cmid, 3),
               "mid": {"block_1": res(cmid, cmid), "attn_1": attn(cmid),
                       "block_2": res(cmid, cmid)},
               "up": up, "norm_out": ("gn", ch * mult[0]),
               "conv_out": conv(ch * mult[0], 3, 3)}
    ks = q["quant_conv_ks"]
    return {"encoder": encoder, "decoder": decoder,
            "quant_conv": conv(zc, zc, ks), "post_quant_conv": conv(zc, zc, ks)}


def _leaves(tree, out: List[Tuple]) -> List[Tuple]:
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def vqvae_params(q: Dict, seed: int, device) -> Dict:
    """VQVAE parameters in the port's layout, f32: convolutions uniform in
    +/- 1/sqrt(fan_in) (one draw for all of them), GroupNorm ones and
    zeros, the codebook a normal clipped at +/-2, the phi convolutions
    uniform in +/- 1/sqrt(9 Cvae) with zero biases."""
    g = generator(seed, 2, device)
    layout = vqvae_layout(q)
    convs = [s for kind, s in _leaves(layout, []) if kind == "conv"]
    total = sum(math.prod(s) + s[0] for s in convs)
    flat = torch.rand(total, generator=g, device=device).mul_(2).sub_(1)
    pos = 0

    def build(node):
        nonlocal pos
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        kind, shape = node
        if kind == "gn":
            return {"g": torch.ones(shape, device=device),
                    "b": torch.zeros(shape, device=device)}
        lim = 1.0 / math.sqrt(math.prod(shape[1:]))
        n, o = math.prod(shape), shape[0]
        w = flat[pos:pos + n].view(shape) * lim
        b = flat[pos + n:pos + n + o] * lim
        pos += n + o
        return {"w": w, "b": b}

    params = build(layout)
    del flat
    V, Cv, K = q["vocab_size"], q["z_channels"], q["share_quant_resi"]
    params["quant"] = {
        "codebook": torch.randn((V, Cv), generator=g, device=device).clamp_(-2, 2),
        "phi_w": torch.rand((K, Cv, Cv, 3, 3), generator=g, device=device)
        .mul_(2).sub_(1).div_(math.sqrt(Cv * 9)),
        "phi_b": torch.zeros((K, Cv), device=device),
    }
    return params


def images(n: int, reso: int, seed: int, device) -> torch.Tensor:
    """(n, 3, reso, reso) f32 images uniform in [-1, 1], the port's
    ``train/data.py:SyntheticImageNet`` distribution, drawn on the card in
    one call."""
    g = generator(seed, 3, device)
    return torch.rand((n, 3, reso, reso), generator=g, device=device) \
        .mul_(2).sub_(1)


def labels(n: int, num_classes: int, seed: int, device) -> torch.Tensor:
    """(n,) uniform class labels, int64."""
    g = generator(seed, 4, device)
    return torch.randint(0, num_classes, (n,), generator=g, device=device)

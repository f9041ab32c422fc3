"""The INT8 3x3 convolution's launch plan (``conv_plan``) on the CPU.

The plan is held at every 3x3 site of the default VQVAE's channels-last
decoder (enumerated by running the decoder on the meta device: the 29
eligible sites of the dynamic W8A8 decoder, the all-int8 server's eight at
256^2 among them) at the server's batch and the calibration's. The wide
path's tiling (256-pixel boxes, 128-channel steps of each tap, then a tail
chunk, zeros where a box leaves the image or the channels) is emulated on
the CPU in exact integer arithmetic and held bit for bit against
``conv3x3_s8_plain``.
"""

from collections import Counter

import pytest
import torch
import torch.nn.functional as F

from sdvar_tpu_torch.config import VQVAEConfig
from sdvar_tpu_torch.models import vqvae as V
from sdvar_tpu_torch.ops.kernels.conv_s8 import (
    SMS,
    TMA_KC,
    TMA_TILE_M,
    TMA_TILE_N,
    TMA_SMEM,
    conv3x3_s8_kernel,
    conv3x3_s8_plain,
    conv_plan,
)
from sdvar_tpu_torch.tools.ab_conv_s8 import SHAPES as AB_SHAPES

MAX_SMEM = 232448


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta(v) for v in tree)
    return tree.to("meta") if isinstance(tree, torch.Tensor) else tree


def _decoder_sites(B):
    """((B, H, W, C), O) of every eligible 3x3 conv the decoder runs, in
    call order (shapes only: the decoder runs on the meta device)."""
    cfg = VQVAEConfig()
    p = _meta(V.init_vqvae_params(cfg, seed=0, device="cpu"))
    sites = []

    def record(layer, x):
        sites.append((tuple(x.shape), layer["w"].shape[0]))
        return None

    z = torch.empty(B, cfg.z_channels, 16, 16, device="meta",
                    dtype=torch.bfloat16).to(memory_format=torch.channels_last)
    z = V.conv2d_nhwc(p["post_quant_conv"], z, plan=record)
    V.decoder_forward_nhwc(cfg, p["decoder"], z, record)
    return sites


@pytest.fixture(scope="module")
def sites16():
    return _decoder_sites(16)


def test_decoder_sites_are_the_tools_shapes(sites16):
    """29 eligible sites, the eight of the all-int8 server at 256^2 (seven
    160 -> 160, conv_out 160 -> 3), as tools/ab_conv_s8.py weighs them."""
    got = Counter((shape[1], shape[3], O) for shape, O in sites16)
    want = Counter({(hw, C, O): n for hw, C, O, _, n in AB_SHAPES})
    server = Counter({(hw, C, O): n for hw, C, O, n, _ in AB_SHAPES if n})
    assert len(sites16) == 29 and got == want
    assert server == Counter((shape[1], shape[3], O) for shape, O in sites16
                             if shape[1] == 256)
    assert server == Counter({(256, 160, 160): 7, (256, 160, 3): 1})


@pytest.mark.parametrize("B", [16, 8, 32])
def test_conv_plan_at_every_decoder_site(B):
    for (Bs, H, W, C), O in _decoder_sites(B):
        plan = conv_plan(Bs, H, W, C, O)
        if O < 96 or C % 16:
            assert plan["path"] == "mma"
            assert plan["block_n"] == (160 if O >= 96 else 8)
            continue
        assert plan["path"] == "tma"
        bw, bh = plan["box_w"], plan["box_h"]
        assert bw * bh == TMA_TILE_M and bw & (bw - 1) == 0 and 8 <= bw <= 256
        # the decoder's power-of-two widths tile with no padded pixel
        assert W % bw == 0 and H % bh == 0
        tiles = (-(-O // TMA_TILE_N), W // bw, H // bh, Bs)
        assert plan["tiles"] == tiles
        n_tiles = tiles[0] * tiles[1] * tiles[2] * tiles[3]
        assert plan["n_tiles"] == n_tiles and plan["grid"] == min(n_tiles, SMS)
        assert plan["k_steps"] == 9 * (C // TMA_KC)
        rest = C % TMA_KC
        assert plan["tail"] == (0 if rest == 0 else
                                min(k for k in (32, 64, 128) if k >= rest))
        assert plan["smem_bytes"] == TMA_SMEM <= MAX_SMEM
        assert plan["threads"] == 384


@pytest.mark.parametrize("shape,path,block_n", [
    ((2, 8, 37, 48, 96), "tma", 160),      # C % 16 == 0, O at the edge
    ((2, 8, 37, 160, 95), "mma", 8),       # O < 96: the narrow mma.sync tile
    ((16, 256, 256, 160, 3), "mma", 8),    # conv_out: the narrow tile
    ((2, 16, 32, 12, 160), "mma", 160),    # C % 16 != 0: mma.sync, wide tile
    ((1, 16, 32, 8, 12), "mma", 8),
])
def test_conv_plan_routes(shape, path, block_n):
    plan = conv_plan(*shape)
    assert plan["path"] == path and plan["block_n"] == block_n


def test_conv_plan_picks_the_box_with_fewest_padded_pixels():
    # W = 33 (ragged) over H = 8: 64 x 4 and 32 x 8 pad to 512 pixels, 16 x
    # 16 to 768; the widest of the fewest
    plan = conv_plan(1, 8, 33, 160, 200)
    assert (plan["box_w"], plan["box_h"]) == (64, 4)
    assert plan["tiles"] == (2, 1, 2, 1)
    # W = 40 over H = 16: 16 x 16 pads to 768 pixels, 32 x 8 and 64 x 4 to
    # 1024, 8 x 32 to 1280
    plan = conv_plan(1, 16, 40, 32, 160)
    assert (plan["box_w"], plan["box_h"]) == (16, 16)


@pytest.mark.parametrize("args,match", [
    ((1, 8, 32, 18, 160), "multiple of 4"),
    ((0, 8, 32, 16, 160), "no launch"),
])
def test_conv_plan_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        conv_plan(*args)


def test_conv_wrapper_refuses_cpu_tensors():
    x8 = torch.zeros(1, 8, 32, 16, dtype=torch.int8)
    wk = torch.zeros(160, 3, 3, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3_s8_kernel(x8, wk, torch.ones(160), torch.zeros(160))


def _box(t, starts, sizes):
    """t[starts : starts + sizes] along each dim, zeros outside t (as TMA
    fills a box that leaves the tensor)."""
    out = torch.zeros(sizes, dtype=t.dtype)
    src, dst = [], []
    for st, sz, n in zip(starts, sizes, t.shape):
        lo, hi = max(st, 0), min(st + sz, n)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - st, hi - st))
    out[tuple(dst)] = t[tuple(src)]
    return out


def _emulate_wide_path(x8, wk, scale, bias, out_dtype):
    """The wide path's tiles and K steps in exact integer arithmetic: per
    tile, per tap, 128-channel x and weight boxes then the tail's, at the
    kernel's coordinates (the weight box of the tail runs into the next
    tap's channels, against x's zeros past C)."""
    B, H, W, C = x8.shape
    O = wk.shape[0]
    plan = conv_plan(B, H, W, C, O)
    assert plan["path"] == "tma"
    bw, bh, kt = plan["box_w"], plan["box_h"], plan["tail"]
    x = x8.long()
    wflat = wk.reshape(O, 9 * C).long()
    acc = torch.zeros(B, H, W, O, dtype=torch.long)
    n_t, w_t, h_t, _ = plan["tiles"]
    steps = [(tap, c * TMA_KC, TMA_KC) for tap in range(9)
             for c in range(C // TMA_KC)] + [(tap, C // TMA_KC * TMA_KC, kt)
                                              for tap in range(9) if kt]
    for b in range(B):
        for th in range(h_t):
            for tw in range(w_t):
                for tn in range(n_t):
                    h0, w0, n0 = th * bh, tw * bw, tn * TMA_TILE_N
                    tile = torch.zeros(bh * bw, TMA_TILE_N, dtype=torch.long)
                    for tap, c0, kc in steps:
                        dy, dx = tap // 3, tap % 3
                        xb = _box(x[b], (h0 + dy - 1, w0 + dx - 1, c0), (bh, bw, kc))
                        wb = _box(wflat, (n0, tap * C + c0), (TMA_TILE_N, kc))
                        tile += xb.reshape(bh * bw, kc) @ wb.T
                    tile = tile.reshape(bh, bw, TMA_TILE_N)
                    hs, ws = min(bh, H - h0), min(bw, W - w0)
                    ns = min(TMA_TILE_N, O - n0)
                    acc[b, h0:h0 + hs, w0:w0 + ws, n0:n0 + ns] = tile[:hs, :ws, :ns]
    y = acc.to(torch.int32).float() * scale.float() + bias.float()
    return y.to(out_dtype)


@pytest.mark.parametrize("shape", [(2, 8, 37, 160, 200), (1, 9, 20, 48, 96),
                                   (1, 8, 16, 320, 160)])
def test_wide_path_tiling_is_the_convolution(shape):
    B, H, W, C, O = shape
    g = torch.Generator().manual_seed(B * H + W + C + O)
    x8 = torch.randint(-127, 128, (B, H, W, C), generator=g, dtype=torch.int8)
    wk = torch.randint(-127, 128, (O, 3, 3, C), generator=g, dtype=torch.int8)
    scale = torch.rand(O, generator=g) * 2e-3
    bias = torch.randn(O, generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(_emulate_wide_path(x8, wk, scale, bias, dtype),
                           conv3x3_s8_plain(x8, wk, scale, bias, dtype))

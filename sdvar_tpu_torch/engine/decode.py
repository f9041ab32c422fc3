"""KV-cached CFG decode: labels -> 10 scales -> f_hat -> images (the
counterpart of ``sdvar_tpu/engine/decode.py``).

Per scale: one transformer forward over the scale's tokens against the KV
cache (classifier-free guidance by batch doubling, strength
t = cfg * si / (S-1)), top-k/top-p sampling through the fused sampler with
per-request seeds, and the residual-VQ state update. PyTorch runs eagerly,
so the scale loop is a Python loop; the cache is written in place.
`scale_step` and `decode_all_scales` run with TF32 off
(``utils.device.full_f32``): the head, the resizes and the phi convs are
f32 as in the JAX package.

Under a mesh (``ops.partition.set_tp_mesh``) every rank is handed the
whole batch's labels and seeds and decodes its own contiguous slice of
requests (the batch split over "data"), with this rank's shard of the
parameters and of the KV cache; the request seeds are the whole batch's
(a request's stream hashes its global slot), so its tokens do not depend
on the mesh. ``gather`` returns the whole batch in request order on every
rank, else each rank gets its own rows.

The JAX version pads each scale's queries to a multiple of 64 (an XLA
matmul workaround) and writes the pad rows into the next scale's cache
slots; this port does not, so raw cache rows past ``kv_len`` differ from
JAX's while everything that is read agrees.

CUDA graphs: a decode into a cache its caller reuses, on a card and with
no mesh, replays each scale's transformer forward (``M.apply_transformer``
over the scale's tokens against the cache) from a CUDA graph captured
against that cache (``ScaleGraphs``): a scale's ~2,000 launches become one.
A shape's graph is captured on its first decode, in place of that decode's
eager forward, and replayed at once to give the scale its output; so the
first decode costs what an eager one does, plus the graphs' instantiation.
The head, CFG, the sampler, the code embedding and the next scale's input
stay eager, each allocating its output as before: nothing a caller holds
(logits, ids, f_hat) is a graph's buffer. A decode without a reused cache
(a graph holds the cache's addresses), on the CPU, under a mesh (gloo
cannot be captured), and ``scale_step`` called on its own (the speculative
engine, with its attention biases) run eagerly. The launch counters of
the port's kernels tick when a graph is captured, not when it is replayed.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.models import quantizer as Q
from sdvar_tpu_torch.models import var as M
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.models.var import KVCache
from sdvar_tpu_torch.ops.attention import get_attention_impl, use_cache_kernel
from sdvar_tpu_torch.ops.kernels.sampling import gumbel_from_bits, rowhash_bits
from sdvar_tpu_torch.ops.partition import (
    data_rows,
    gather_data,
    gather_vocab,
    tp_mesh_active,
)
from sdvar_tpu_torch.ops.quantization import QuantizedKVCache
from sdvar_tpu_torch.ops.sampling import (
    cfg_double,
    cfg_mix,
    cfg_pair,
    fold_seeds,
    gumbel_softmax,
    request_seeds,
    row_seeds,
    sample_with_top_k_top_p,
)
from sdvar_tpu_torch.utils.device import full_f32, resolve_device
from sdvar_tpu_torch.utils.profiling import mark, span

Seeds = Union[int, Sequence[int], torch.Tensor]
Cache = Union[KVCache, QuantizedKVCache]

SMOOTH_STREAM = 0x5300  # the more_smooth noise's sub-stream of a row's seed


def smooth_embed(mixed: torch.Tensor, ratio: float, codebook: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
    """``more_smooth``'s scale embedding: the codebook weighted by a
    Gumbel-softmax of the CFG'd logits (B, l, V) times (1 + ratio), at
    temperature max(0.27 * (1 - 0.95 ratio), 0.005), with the given (B, l,
    V) Gumbel ``noise`` -> (B, l, Cvae) f32."""
    tau = max(0.27 * (1 - ratio * 0.95), 0.005)
    soft = gumbel_softmax(mixed * (1 + ratio), noise, tau=tau)
    return torch.einsum("blv,vc->blc", soft, codebook.float())


@dataclasses.dataclass
class DecodeState:
    """Carries the decode across scales."""

    f_hat: torch.Tensor      # (B, Cvae, HW, HW) f32
    next_map: torch.Tensor   # (B, Cvae, pn', pn') input for the next scale
    cache: Cache
    seeds: torch.Tensor      # (B,) request seeds


def init_decode(
    var_cfg: VARConfig, params, label_B, seed: Seeds = 0,
    dtype=torch.bfloat16, kv_mode: str = "bf16",
    cache: Optional[Cache] = None, device="cuda",
) -> Tuple[DecodeState, torch.Tensor, torch.Tensor]:
    """Empty state, sos (2B, C) f32 and lvl_pos (L, C) f32 for a batch.

    The uncond rows use class id ``num_classes``. ``kv_mode``: "bf16",
    "f32" or "int8" (``QuantizedKVCache``: per-token-scaled INT8).
    ``cache``: a preallocated KVCache or QuantizedKVCache to reuse (every
    scale reads only rows written earlier in the same decode). Under a
    mesh, ``label_B`` and ``seed`` are the whole batch's and the state is
    this rank's rows.
    """
    dev = resolve_device(device)
    if params["class_emb"].device != dev:
        raise ValueError(f"parameters lie on {params['class_emb'].device}, "
                         f"decode asked for {dev}")
    if kv_mode not in ("bf16", "f32", "int8"):
        raise ValueError(f"unknown kv_mode {kv_mode!r} (bf16 | f32 | int8)")
    label_B = torch.as_tensor(label_B, dtype=torch.long, device=dev)
    B_all = label_B.shape[0]
    seeds = request_seeds(seed, B_all, dev)
    rows = data_rows(B_all)
    label_B, seeds = label_B[rows], seeds[rows]
    B = label_B.shape[0]
    label_2B = cfg_pair(label_B, torch.full_like(label_B, var_cfg.num_classes))
    lvl_pos = M.lvl_pos_embed(var_cfg, params).float()
    sos = params["class_emb"][label_2B].float()
    HW = var_cfg.patch_nums[-1]
    if cache is None and kv_mode == "int8":
        cache = QuantizedKVCache.create(var_cfg, 2 * B_all, device=dev)
    elif cache is None:
        cache = KVCache.create(
            var_cfg, 2 * B_all, device=dev,
            dtype=torch.float32 if kv_mode == "f32" else torch.bfloat16)
    state = DecodeState(
        f_hat=torch.zeros((B, var_cfg.Cvae, HW, HW), device=dev),
        next_map=torch.zeros((B, var_cfg.Cvae, 1, 1), device=dev),
        cache=cache,
        seeds=seeds,
    )
    return state, sos, lvl_pos


def graphs_apply(cache: Optional[Cache], device) -> bool:
    """Whether a decode replays its scales' transformer forwards from CUDA
    graphs: into a cache the caller passed in to reuse (a graph holds the
    cache's addresses), on a card, and with no mesh of more than one rank
    (its collectives cannot be captured). A step with an attention bias
    runs eagerly whatever this says (``scale_step``)."""
    return (cache is not None and torch.device(device).type == "cuda"
            and not tp_mesh_active())


def _weights_key(tree) -> tuple:
    """Where a parameter tree's tensors lie: each one's address, dtype,
    shape and strides, in tree order. A graph reads its weights where they
    lay at its capture, so it replays only for a tree that matches."""
    out = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            out.append((t.data_ptr(), t.dtype, t.shape, t.stride()))
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):  # the INT8 leaves are NamedTuples
            for v in t:
                walk(v)

    walk(tree)
    return tuple(out)


# device index -> (the graphs' shared pool, the capture stream, a graph
# that holds the pool: a pool whose graphs have all gone is gone too, and
# capturing into its handle again fails)
_POOLS: Dict[int, tuple] = {}
_CAPTURING = threading.Lock()  # one capture at a time: one capture stream


@dataclasses.dataclass
class _ScaleGraph:
    graph: "torch.cuda.CUDAGraph"
    x: torch.Tensor   # the static input: the scale's tokens
    h: torch.Tensor   # the static output: the block stack's


@dataclasses.dataclass
class _GraphGroup:
    """The graphs of one batch shape on one cache: the static conditioning
    (the first decode's own ``sos`` and ``mods``, refreshed in place by
    each later decode) and a graph per scale."""

    sos: torch.Tensor
    mods: torch.Tensor
    scales: Dict[int, _ScaleGraph] = dataclasses.field(default_factory=dict)


class ScaleGraphs:
    """One decode's use of the CUDA graphs captured against its cache.

    The graphs live on the cache (so they go with it), keyed by the batch
    rows, the compute dtype, the attention switches (``set_attention_impl``,
    ``set_cache_kernel``) and where the weights lie (``_weights_key``); a
    cache serves one set of weights, and weights that moved drop its
    graphs. All graphs capture into one pool a device and replay one at a
    time on the dispatching thread's current stream, in the order its
    decodes run.

    A scale's first decode captures its graph on a side stream (its eager
    forward's Python, recording instead of launching) and replays it: no
    eager forward runs for a graphed shape, not even the process's first
    (cuBLAS and the port's kernels initialise inside a capture)."""

    def __init__(self, var_cfg: VARConfig, params, cache: Cache,
                 sos: torch.Tensor, mods: torch.Tensor, dtype):
        self.cfg, self.params, self.cache = var_cfg, params, cache
        self.dev = sos.device
        store = getattr(cache, "_scale_graphs", None)
        if store is None:
            store = cache._scale_graphs = {}
        weights = _weights_key(params)
        key = (sos.shape[0], dtype, get_attention_impl(), use_cache_kernel(),
               weights)
        if any(k[-1] != weights for k in store):
            store.clear()
        group = store.get(key)
        if group is None:
            group = store[key] = _GraphGroup(sos, mods)
        else:
            group.sos.copy_(sos)
            group.mods.copy_(mods)
        self.group = group

    def forward(self, si: int, x: torch.Tensor, begin: int,
                end: int) -> torch.Tensor:
        """The block stack over scale ``si``'s tokens ``x``, writing the
        cache at [begin, end) and attending over [0, end): a replay, or the
        shape's capture on its first decode."""
        g = self.group.scales.get(si)
        if g is not None:
            g.x.copy_(x)
            with span("sdvar.decode.replay", si=si):
                g.graph.replay()
            return g.h
        run = lambda: M.apply_transformer(  # noqa: E731
            self.cfg, self.params, x, self.group.sos, cache=self.cache,
            cache_begin=begin, kv_len=end, mods=self.group.mods)
        with span("sdvar.decode.capture", rows=x.shape[0], si=si):
            graph, out = _capture(run, self.dev)
        self.group.scales[si] = _ScaleGraph(graph, x, out)
        with span("sdvar.decode.replay", si=si):
            graph.replay()
        return out


M_TOP_PAD = -2          # glibc's mallopt parameter
HEAP_PAD = 64 << 20     # glibc's largest thread heap (HEAP_MAX_SIZE, 64-bit)


def _keep_host_heaps() -> None:
    """Have glibc's malloc keep ``HEAP_PAD`` bytes free at the top of its
    heaps. A capture and its instantiation make and free tens of MB of host
    memory in the CUDA driver, in the dispatching thread; that thread's
    malloc arena would unmap each emptied 64 MiB heap and map it again at
    the next capture, which on the H100 host tripled a capture's time
    (PERF.md, section 6). A pad of a whole heap keeps them. It holds for
    the whole process from then on and is never reset: each malloc arena
    keeps up to 64 MiB of freed memory instead of returning it (PERF.md,
    section 6, has what it cost). No-op without glibc."""
    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (AttributeError, OSError):
        return
    mallopt.argtypes, mallopt.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    mallopt(M_TOP_PAD, HEAP_PAD)


def _capture(fn, dev: torch.device):
    """Capture ``fn()``'s launches into a new CUDA graph on the device's
    capture stream, into the device's shared pool -> (graph, fn's output).
    Nothing runs; other threads may go on using the card meanwhile. The
    end of the capture and the graph's instantiation are the span
    ``sdvar.decode.instantiate`` (host time only: no event may be recorded
    on a capturing stream)."""
    with _CAPTURING:
        if dev.index not in _POOLS:
            _keep_host_heaps()
            pool, side = torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev)
            keeper = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                keeper.capture_begin(pool=pool, capture_error_mode="thread_local")
                torch.empty(1, device=dev).zero_()
                keeper.capture_end()
            _POOLS[dev.index] = (pool, side, keeper)
        pool, side, _ = _POOLS[dev.index]
        cur = torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                t = time.perf_counter_ns()
                graph.capture_end()  # ends the capture, instantiates
                mark("sdvar.decode.instantiate", t, time.perf_counter_ns())
        cur.wait_stream(side)
    return graph, out


@full_f32()
def scale_step(
    var_cfg: VARConfig, vae_cfg: VQVAEConfig, params, quant_params,
    si: int, state: DecodeState, sos: torch.Tensor, lvl_pos: torch.Tensor,
    samp: SamplingConfig, dtype=torch.bfloat16,
    mods: Optional[torch.Tensor] = None,
    attn_bias: Optional[torch.Tensor] = None,
    graphs: Optional[ScaleGraphs] = None,
) -> Tuple[DecodeState, torch.Tensor]:
    """One scale of KV-cached CFG decode -> (state', ids (B, pn^2) int32).
    ``attn_bias``: an optional (pn^2, kv_len) additive bias for this step
    (None attends the whole cache, the baseline). ``graphs``: the
    decode's ``ScaleGraphs``, which run the block stack (``mods`` and
    ``sos`` are then theirs); None runs it eagerly."""
    pn = var_cfg.patch_nums[si]
    bg, ed = var_cfg.begin_ends[si]
    B = sos.shape[0] // 2

    if si == 0:
        x = (sos[:, None, :] + params["pos_start"][None]
             + lvl_pos[None, : var_cfg.first_l]).to(dtype)
    else:
        # (B, C, pn, pn) -> (B, pn^2, C): tokens in row-major spatial order
        nm = state.next_map.reshape(B, var_cfg.Cvae, pn * pn).transpose(1, 2)
        x = M.word_embed(params, nm, torch.float32) + lvl_pos[None, bg:ed]
        x = cfg_double(x).to(dtype)

    if graphs is None or attn_bias is not None:
        h = M.apply_transformer(var_cfg, params, x, sos, attn_bias=attn_bias,
                                cache=state.cache, cache_begin=bg, kv_len=ed,
                                mods=mods)
    else:
        h = graphs.forward(si, x, bg, ed)
    logits = M.get_logits(var_cfg, params, h, sos)  # (2B, pn^2, V) f32

    ratio = si / var_cfg.num_stages_minus_1
    mixed = cfg_mix(logits, samp.cfg * ratio)
    seeds = row_seeds(state.seeds, si, pn * pn)
    ids = sample_with_top_k_top_p(mixed, seeds, samp.top_k, samp.top_p,
                                  vocab=var_cfg.vocab_size)

    if samp.more_smooth:
        # the whole codebook mixed by a Gumbel-softmax (visualisation only,
        # not for FID); its noise from the rows' own stream, folded apart
        noise = gumbel_from_bits(rowhash_bits(row_seeds(
            fold_seeds(state.seeds, SMOOTH_STREAM), si, pn * pn),
            var_cfg.vocab_size))
        h_BlC = smooth_embed(gather_vocab(mixed, var_cfg.vocab_size), ratio,
                             quant_params["codebook"],
                             noise.view(B, pn * pn, -1))
    else:
        h_BlC = Q.embed(quant_params, ids)                    # (B, pn^2, Cvae)
    h_BChw = h_BlC.transpose(1, 2).reshape(B, var_cfg.Cvae, pn, pn)
    f_hat, next_map = Q.next_autoregressive_input(
        vae_cfg, quant_params, si, state.f_hat, h_BChw)
    return dataclasses.replace(state, f_hat=f_hat, next_map=next_map), ids


@torch.inference_mode()
@full_f32()
def decode_all_scales(
    var_cfg: VARConfig, vae_cfg: VQVAEConfig, params, quant_params,
    label_B, seed: Seeds = 0,
    samp: SamplingConfig = SamplingConfig(), dtype=torch.bfloat16,
    return_ids: bool = False, kv_mode: str = "bf16",
    cache: Optional[Cache] = None, return_cache: bool = False,
    device="cuda", gather: bool = False,
):
    """All scales -> f_hat (B, Cvae, HW, HW), optionally with the sampled
    ids (B, L) and the KV cache (pass it back as ``cache`` to reuse it).
    Under a mesh the rows are this rank's, or with ``gather`` the whole
    batch's in request order (the cache stays this rank's). A reused
    ``cache`` on a card, with no mesh, replays each scale's block stack
    from a CUDA graph captured against it (``ScaleGraphs``; the module's
    docstring). The first capture in a process sets glibc's malloc top pad
    to 64 MiB for the whole process (``_keep_host_heaps``). Spans:
    ``sdvar.decode``, and under it ``sdvar.decode.scale`` a scale, under
    which ``sdvar.decode.replay`` (``si``), or ``sdvar.decode.capture``
    (``rows``, ``si``; with ``sdvar.decode.instantiate`` inside) and then
    the replay."""
    with span("sdvar.decode"):
        state, sos, lvl_pos = init_decode(var_cfg, params, label_B, seed,
                                          dtype, kv_mode=kv_mode, cache=cache,
                                          device=device)
        mods = M.precompute_modulations(var_cfg, params, sos)
        graphs = None
        if graphs_apply(cache, device):
            graphs = ScaleGraphs(var_cfg, params, state.cache, sos, mods, dtype)
        ids_all = []
        for si in range(var_cfg.num_scales):
            with span("sdvar.decode.scale", si=si):
                state, ids = scale_step(var_cfg, vae_cfg, params, quant_params,
                                        si, state, sos, lvl_pos, samp, dtype,
                                        mods=mods, graphs=graphs)
            ids_all.append(ids)
        out = (gather_data(state.f_hat) if gather else state.f_hat,)
        if return_ids:
            ids = torch.cat(ids_all, dim=1)
            out += (gather_data(ids) if gather else ids,)
    if return_cache:
        out += (state.cache,)
    return out if len(out) > 1 else out[0]


@torch.inference_mode()
def generate_images(
    var_cfg: VARConfig, vae_cfg: VQVAEConfig, var_params, vae_params,
    label_B, seed: Seeds = 0,
    samp: SamplingConfig = SamplingConfig(), dtype=torch.bfloat16,
    kv_mode: str = "bf16", device="cuda", gather: bool = False,
) -> torch.Tensor:
    """Labels -> images (B, 3, H, W) in [0, 1], f32.

    ``seed``: an int for the whole batch, or one seed per request; with
    one seed per request, a request's image depends only on its label and
    seed, not on its batch slot. ``kv_mode`` as in ``init_decode``. Under
    a mesh each rank decodes the pixels of its own rows; ``gather`` as in
    ``decode_all_scales``."""
    f_hat = decode_all_scales(var_cfg, vae_cfg, var_params,
                              vae_params["quant"], label_B, seed, samp, dtype,
                              kv_mode=kv_mode, device=device)
    with span("sdvar.pixels"):
        img = (VQ.fhat_to_img(vae_cfg, vae_params, f_hat) + 1.0) * 0.5
    return gather_data(img) if gather else img

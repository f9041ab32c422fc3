"""One training step of VAR on a frozen VQVAE tokenizer (the counterpart of
``sdvar_tpu/train/trainer.py``).

Per step: the frozen VQVAE encodes the images into ground-truth token ids
(under ``no_grad``; f32 with TF32 off, or the channels-last bf16 encoder
with ``tokenize_bf16``, or ids read from a token dataset with
``pretokenized``), the quantizer rebuilds the teacher-forcing input, the
VAR forward and backward give a token-weighted cross entropy (uniform
1/L, label smoothing, the progressive stage's warm-up factor) and its
gradients, accumulated over ``grad_accum`` micro-batches, then the
optimizer: clipping by the global norm, then Adam (b1 0.9, b2 0.95,
eps 1e-8, bias-corrected) or, with ``kind="adafactor"``, factored second
moments, both as optax computes them; then the decoupled weight decay and
the learning rate by hand, ``p -= lr * (u + wd * p * mask)``, with the
no-decay mask of ``decay_mask``.

Parameters are the port's nested dicts of f32 tensors (the master
weights); the forward casts them to ``dtype`` (bf16 by default). The
optimizer state is a dict of trees of the parameters' shapes: ``mu`` and
``nu`` (Adam) or ``v_row``, ``v_col`` and ``v`` (factored RMS, with
placeholders of shape (1,) where a leaf is not factored, as optax keeps
them), and ``count``, the updates taken.

On a mesh (``ops.partition.set_tp_mesh``; ``shard_train_state`` cuts a
whole state) each rank holds its shard of the parameters and of their
optimizer state (each moment takes its parameter's spec;
``opt_state_specs``) and its rows of the batch. The step then averages
the gradients over "data" before the clip (one all-reduce a bucket,
``ops.partition.mean_over_data``); the global norm sums the squares of the
split leaves over "model" and counts a replicated leaf once; the factored
RMS decides its axes on the whole shape and all-reduces its row and
column means over a split axis; the metrics are averaged over "data", and
``z_voc_usage`` comes from the vocabulary counts summed over "data". A
replicated leaf gets the same gradient, and so the same bits, on every
model rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sdvar_tpu_torch.config import VARConfig, VQVAEConfig
from sdvar_tpu_torch.models import quantizer as Q
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.models.var import var_train_forward
from sdvar_tpu_torch.ops.partition import (
    MODEL,
    data_count,
    get_tp_mesh,
    mean_over_data,
    reduce_data,
    tp_mesh_active,
)
from sdvar_tpu_torch.parallel.mesh import MODEL_QKV, shard_tree, var_param_specs
from sdvar_tpu_torch.train.schedule import NOWD_KEYS
from sdvar_tpu_torch.utils.device import full_f32

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.95, 1e-8
FACTORED_DECAY, FACTORED_EPS, FACTORED_MIN_DIM = 0.8, 1e-30, 128
METRICS = ("Lm", "Lt", "Accm", "Acct", "z_voc_usage")


@dataclasses.dataclass
class TrainState:
    params: Dict
    opt_state: Dict
    step: int = 0


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts and lists)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, list):
        return [tree_map(fn, *(t[i] for t in trees)) for i in range(len(t0))]
    return fn(*trees)


def tree_leaves(tree, path: str = ""):
    """(path, leaf) pairs in a fixed order; paths join dict keys with
    '/'."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def decay_mask(params: Dict) -> Dict:
    """True where weight decay applies: tensors of more than one dimension
    that are not biases and hold no key of ``NOWD_KEYS``."""

    def rule(path, a) -> bool:
        leaf = path.rsplit("/", 1)[-1]
        if a.dim() <= 1 or leaf == "b" or "bias" in path or leaf.endswith("_b"):
            return False
        return not any(k in path for k in NOWD_KEYS)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, f"{path}/{i}" if path else str(i))
                    for i, v in enumerate(tree)]
        return rule(path, tree)

    return walk(params, "")


# ---------------------------------------------------------------------------
# the optimizer: global-norm clipping, then Adam or factored RMS (optax's)
# ---------------------------------------------------------------------------

def mesh_layout(var_cfg: VARConfig):
    """The ``layout`` the optimizer takes: (mesh, VAR parameter specs) of
    the registered mesh of more than one rank, else None."""
    if not tp_mesh_active():
        return None
    mesh = get_tp_mesh()
    return mesh, var_param_specs(var_cfg, mesh)


def split_axes(spec, mesh) -> Tuple[int, ...]:
    """The axes of a leaf that split over "model" on ``mesh``."""
    if mesh is None or spec is None or mesh.model == 1:
        return ()
    return tuple(i for i, e in enumerate(spec) if e in (MODEL, MODEL_QKV))


def _split_tree(tree, layout):
    """The axes of each leaf of ``tree`` that split over "model" under
    ``layout`` (``mesh_layout``); () everywhere without one."""
    if layout is None:
        return tree_map(lambda _: (), tree)
    mesh, specs = layout
    return tree_map(lambda _, spec: split_axes(spec, mesh), tree, specs)


def global_norm(grads, layout=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, f32. Under ``layout``
    (``mesh_layout``) the squares of the leaves that split over "model"
    are summed over the model ranks, and a replicated leaf counts once."""
    sums = {False: [], True: []}  # split over "model" or not

    def add(g, axes):
        sums[bool(axes)].append((g.float() * g.float()).sum())

    tree_map(add, grads, _split_tree(grads, layout))
    total = sum(sums[False])
    if sums[True]:
        total = total + layout[0].all_reduced(sum(sums[True]), MODEL)
    return torch.sqrt(total)


def _factored_dims(shape, min_dim: int = FACTORED_MIN_DIM):
    """optax's rule: the two largest axes (d1, d0), where the second
    largest is at least ``min_dim``; else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


def opt_state_specs(params: Dict, specs: Dict, kind: str = "adamw",
                    mesh=None) -> Dict:
    """The spec tree of the optimizer state of ``params`` under parameter
    ``specs``: Adam's moments take their parameter's spec; a factored
    leaf's row moment its spec without the reduced column axis, its column
    moment without the row axis; the placeholders and the count are whole.
    ``params``: the whole tree, or with ``mesh`` this rank's shards of it
    (the factored axes are decided on the whole shapes)."""
    if kind == "adamw":
        return {"count": None, "mu": specs, "nu": specs}

    def parts(p, spec):
        split = split_axes(spec, mesh)
        dims = _factored_dims(tuple(n * (mesh.model if i in split else 1)
                                    for i, n in enumerate(p.shape)))
        if dims is None:
            return (None,), (None,), spec
        d1, d0 = dims
        return (tuple(e for i, e in enumerate(spec) if i != d0),
                tuple(e for i, e in enumerate(spec) if i != d1), (None,))

    trio = tree_map(parts, params, specs)
    return {"count": None, "v_row": _pick(trio, 0), "v_col": _pick(trio, 1),
            "v": _pick(trio, 2)}


def train_state_specs(params: Dict, var_cfg: VARConfig, mesh,
                      kind: str = "adamw", whole: bool = False) -> Dict:
    """The spec tree of a ``TrainState`` (as its ``dataclasses`` fields:
    params, opt_state, step) on ``mesh``: what checkpoints cut and
    gather. ``params``: this rank's shard, or the whole tree with
    ``whole``."""
    specs = var_param_specs(var_cfg, mesh)
    return {"params": specs, "step": None, "opt_state": opt_state_specs(
        params, specs, kind, None if whole else mesh)}


def shard_train_state(state: "TrainState", var_cfg: VARConfig, mesh,
                      kind: str = "adamw") -> "TrainState":
    """This rank's shard of a whole train state: the parameters by
    ``var_param_specs``, the optimizer state by ``opt_state_specs`` (the
    factored axes decided on the whole shapes)."""
    specs = train_state_specs(state.params, var_cfg, mesh, kind, whole=True)
    return TrainState(shard_tree(state.params, specs["params"], mesh),
                      shard_tree(state.opt_state, specs["opt_state"], mesh),
                      state.step)


def init_opt_state(params: Dict, kind: str = "adamw") -> Dict:
    """Zero moments for ``params``: Adam's mu and nu, or the factored
    RMS's row, column and full second moments."""
    if kind not in ("adamw", "adafactor"):
        raise ValueError(f"optimizer {kind!r} (adamw | adafactor)")
    dev = next(t for _, t in tree_leaves(params)).device
    count = torch.zeros((), dtype=torch.int32, device=dev)
    if kind == "adamw":
        return {"count": count, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def parts(p):
        dims = _factored_dims(tuple(p.shape))
        one = p.new_zeros((1,))
        if dims is None:
            return one, one, torch.zeros_like(p)
        d1, d0 = dims
        shape = list(p.shape)
        vr = p.new_zeros([s for i, s in enumerate(shape) if i != d0])
        vc = p.new_zeros([s for i, s in enumerate(shape) if i != d1])
        return vr, vc, one

    trio = tree_map(parts, params)
    return {"count": count, "v_row": _pick(trio, 0), "v_col": _pick(trio, 1),
            "v": _pick(trio, 2)}


def _pick(tree, i):
    """Element i of every tuple leaf of a tree of tuples."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def clip_by_global_norm(grads, max_norm: float,
                        norm: Optional[torch.Tensor] = None):
    """optax's rule: unchanged below ``max_norm``, else (g / norm) * max
    (``norm``: the global norm, ``global_norm(grads)`` when not given)."""
    if norm is None:
        norm = global_norm(grads)
    if max_norm <= 0:
        return grads
    small = norm < max_norm
    return tree_map(lambda g: torch.where(small, g, (g / norm) * max_norm),
                    grads)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def adam_update(grads, opt_state: Dict) -> Tuple[Dict, Dict]:
    """Adam's direction and state: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 +
    b2 nu, u = mu_hat / (sqrt(nu_hat) + eps) with the bias corrections
    1 - b^count in f32."""
    count = opt_state["count"] + 1
    mu = tree_map(lambda g, m: (1 - ADAM_B1) * g + ADAM_B1 * m,
                  grads, opt_state["mu"])
    nu = tree_map(lambda g, v: (1 - ADAM_B2) * (g * g) + ADAM_B2 * v,
                  grads, opt_state["nu"])
    c = count.to(torch.float32)
    bc1 = 1 - torch.tensor(ADAM_B1, dtype=torch.float32) ** c
    bc2 = 1 - torch.tensor(ADAM_B2, dtype=torch.float32) ** c

    def direction(m, v):
        m_hat = m / bc1.to(m.device)
        v_hat = v / bc2.to(v.device)
        return m_hat / (torch.sqrt(v_hat) + ADAM_EPS)

    return tree_map(direction, mu, nu), {"count": count, "mu": mu, "nu": nu}


def factored_rms_update(grads, opt_state: Dict,
                        layout=None) -> Tuple[Dict, Dict]:
    """optax's ``scale_by_factored_rms`` (Adafactor's second moments, no
    first moment): decay 1 - (count + 1)^-0.8; a leaf whose two largest
    axes are both >= 128 keeps a row and a column mean of g^2 + 1e-30,
    the others the full second moment; u = g * rsqrt of the estimate.
    Under ``layout`` (``mesh_layout``) the axes are chosen on the leaf's
    whole shape, and a mean over an axis that splits over "model" is
    all-reduced (the shards are of one size: the mean of their means)."""
    t = (opt_state["count"] + 1).to(torch.float32)
    decay = 1.0 - t ** torch.tensor(-FACTORED_DECAY, dtype=torch.float32)

    mesh = layout[0] if layout is not None else None

    def one(g, vr, vc, v, split):
        d = decay.to(g.device)
        whole = tuple(n * (mesh.model if i in split else 1)
                      for i, n in enumerate(g.shape))
        dims = _factored_dims(whole)
        g2 = g * g + FACTORED_EPS
        if dims is None:
            nv = d * v + (1.0 - d) * g2
            return g * nv ** -0.5, vr, vc, nv

        def mean(x, dim, axis, keepdim=False):
            m = x.mean(dim=dim, keepdim=keepdim)
            return mesh.all_reduced(m, MODEL) / mesh.model if axis in split else m

        d1, d0 = dims
        nvr = d * vr + (1.0 - d) * mean(g2, d0, d0)
        nvc = d * vc + (1.0 - d) * mean(g2, d1, d1)
        rd1 = d1 - 1 if d1 > d0 else d1
        row_factor = (nvr / mean(nvr, rd1, d1, keepdim=True)) ** -0.5
        col_factor = nvc ** -0.5
        u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        return u, nvr, nvc, v

    out = tree_map(one, grads, opt_state["v_row"], opt_state["v_col"],
                   opt_state["v"], _split_tree(grads, layout))
    state = {"count": opt_state["count"] + 1, "v_row": _pick(out, 1),
             "v_col": _pick(out, 2), "v": _pick(out, 3)}
    return _pick(out, 0), state


def apply_optimizer(params: Dict, grads: Dict, opt_state: Dict,
                    lr: float, wd: float, clip: float = 2.0,
                    kind: str = "adamw", layout=None) -> Tuple[Dict, Dict]:
    """clip -> Adam or factored RMS -> p + (-lr) * (u + wd * p * mask);
    lr and wd in f32. Returns (params, opt_state), new tensors.
    ``layout``: ``mesh_layout``'s, on a mesh."""
    if clip > 0:
        grads = clip_by_global_norm(grads, clip, global_norm(grads, layout))
    if kind == "adamw":
        u, opt_state = adam_update(grads, opt_state)
    elif kind == "adafactor":
        u, opt_state = factored_rms_update(grads, opt_state, layout)
    else:
        raise ValueError(f"optimizer {kind!r} (adamw | adafactor)")
    mask = decay_mask(params)

    def step(p, d, m):
        lr_t, wd_t = _f32(lr, p), _f32(wd, p)
        return p + (-lr_t) * (d + wd_t * p * float(m))

    return tree_map(step, params, u, mask), opt_state


def step_generator(seed: int, g_it: int, device) -> torch.Generator:
    """The generator of step ``g_it``'s training draws in a run seeded
    ``seed``: seeded from (seed + 1, g_it) alone, the port's counterpart
    of ``jax.random.fold_in(PRNGKey(seed + 1), g_it)``. A resumed run
    therefore replays the draws of the run it continues, and every rank
    of a mesh holds the same generator (the draws of the whole batch, cut
    per rank in ``models.var``)."""
    state = np.random.SeedSequence([seed + 1, g_it]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) >> 1)


def init_train_state(var_params: Dict, optimizer: str = "adamw") -> TrainState:
    return TrainState(params=var_params,
                      opt_state=init_opt_state(var_params, optimizer), step=0)


# ---------------------------------------------------------------------------
# loss and metrics
# ---------------------------------------------------------------------------

def _ce_with_smoothing(logits: torch.Tensor, labels: torch.Tensor,
                       smooth: float) -> torch.Tensor:
    """Per-token cross entropy with label smoothing (torch semantics),
    (B, L)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    if smooth > 0:
        nll = (1.0 - smooth) * nll + smooth * (-logp.mean(dim=-1))
    return nll


def loss_and_metrics(
    var_cfg: VARConfig, params: Dict, label_B: torch.Tensor,
    x_in: torch.Tensor, gt_BL: torch.Tensor,
    generator: Optional[torch.Generator], label_smooth: float,
    loss_weight: Optional[torch.Tensor] = None,
    dtype=torch.bfloat16, prog_si: int = -1, prog_wp: float = 1.0,
    remat: bool = False, masks: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-weighted cross entropy and the five logging metrics (mean and
    last-scale CE without smoothing, mean and last-scale accuracy in %,
    the share of the vocabulary predicted, in %). Progressive training
    (``prog_si`` >= 0) cuts the sequence at ``begin_ends[prog_si][1]`` and
    scales the current stage's token weights by ``prog_wp`` in [0, 1].
    ``generator`` / ``masks``: the training draws (``var_train_forward``)."""
    L = var_cfg.L
    logits = var_train_forward(var_cfg, params, label_B, x_in,
                               generator=generator, masks=masks, dtype=dtype,
                               prog_si=prog_si, remat=remat)
    ed = L if prog_si < 0 else var_cfg.begin_ends[prog_si][1]
    gt = gt_BL[:, :ed].long()
    ce = _ce_with_smoothing(logits, gt, label_smooth)
    lw = (loss_weight if loss_weight is not None else
          torch.full((L,), 1.0 / L, device=logits.device))[:ed]
    if prog_si >= 0:
        bg = var_cfg.begin_ends[prog_si][0]
        lw = lw.clone()
        lw[bg:ed] = lw[bg:ed] * float(min(max(prog_wp, 0.0), 1.0))
    loss = (ce * lw[None]).sum(dim=-1).mean()

    with torch.no_grad():
        last_l = var_cfg.patch_nums[-1] ** 2
        pred = logits.argmax(dim=-1)
        ce_plain = _ce_with_smoothing(logits, gt, 0.0)
        full = prog_si < 0 or ed == L
        V = var_cfg.vocab_size
        counts = reduce_data(torch.bincount(pred.reshape(-1), minlength=V)
                             .float())
        usage = ((counts / counts.sum().clamp(min=1.0) > 0.001 / V)
                 .float().mean() * 100.0)
        minus1 = torch.tensor(-1.0, device=logits.device)
        metrics = {
            "Lm": ce_plain.mean(),
            "Lt": ce_plain[:, -last_l:].mean() if full else minus1,
            "Accm": (pred == gt).float().mean() * 100.0,
            "Acct": ((pred[:, -last_l:] == gt[:, -last_l:]).float().mean()
                     * 100.0 if full else minus1),
            "z_voc_usage": usage,
        }
    return loss, metrics


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def tokenize(var_cfg: VARConfig, vae_cfg: VQVAEConfig, vae_params: Dict,
             img: torch.Tensor, tokenize_bf16: bool = False,
             pretokenized: bool = False):
    """(per-scale ids, gt (B, L), teacher-forcing input (B, L-1, Cvae)),
    without gradients and with TF32 off (the quantizer, its resizes and
    phi convs are f32, as the JAX package's HIGHEST): ``img`` is images,
    or with ``pretokenized`` the stored (B, L) ids."""
    with torch.no_grad(), full_f32():
        if pretokenized:
            gt_BL = img.long()
            gt_idx = [gt_BL[:, bg:ed] for bg, ed in var_cfg.begin_ends]
        else:
            fn = VQ.img_to_idxBl_nhwc if tokenize_bf16 else VQ.img_to_idxBl
            gt_idx = fn(vae_cfg, vae_params, img)
            gt_BL = torch.cat(gt_idx, dim=1)
        x_in = Q.idx_to_var_input(vae_cfg, vae_params["quant"], gt_idx)
    return gt_idx, gt_BL, x_in


def _grad(loss: torch.Tensor, flat):
    """d loss / d each tensor of ``flat``; zeros for one the forward did
    not use (word_embed at the first progressive stage)."""
    return torch.autograd.grad(loss, flat, allow_unused=True,
                               materialize_grads=True)


def train_step(
    var_cfg: VARConfig, vae_cfg: VQVAEConfig, state: TrainState,
    vae_params: Dict, img: torch.Tensor, label_B: torch.Tensor,
    lr: float, wd: float, generator: Optional[torch.Generator] = None,
    clip: float = 2.0, label_smooth: float = 0.0, grad_accum: int = 1,
    dtype=torch.bfloat16, prog_si: int = -1, prog_wp: float = 1.0,
    remat: bool = False, tokenize_bf16: bool = False,
    optimizer: str = "adamw", pretokenized: bool = False, timer=None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step: tokenize -> forward/backward (summed over ``grad_accum``
    micro-batches of B / grad_accum rows, then averaged) -> on a mesh the
    mean over "data" -> clip -> optimizer. ``generator``: the step's
    training draws (None: the forward is deterministic). On a mesh, img
    and label_B are this rank's rows and ``state`` its shard. ``timer``: a
    ``utils.profiling.SpanTimer`` that gets the spans tokenize, forward,
    backward, data all-reduce and optimizer. Returns the new state (new
    tensors; the given one is left as it was) and the metrics, device
    scalars: ``METRICS`` plus loss, grad_norm (before clipping), lr and
    wd."""
    layout = mesh_layout(var_cfg)
    span = timer.span if timer is not None else (
        lambda name: contextlib.nullcontext())
    leaves = tree_map(lambda t: t.detach().requires_grad_(), state.params)
    flat = [t for _, t in tree_leaves(leaves)]

    def forward(img_mb, label_mb):
        with span("tokenize"):
            _, gt_BL, x_in = tokenize(var_cfg, vae_cfg, vae_params, img_mb,
                                      tokenize_bf16, pretokenized)
        with span("forward"):
            return loss_and_metrics(var_cfg, leaves, label_mb, x_in, gt_BL,
                                    generator, label_smooth, dtype=dtype,
                                    prog_si=prog_si, prog_wp=prog_wp,
                                    remat=remat)

    def backward(loss):
        with span("backward"):
            return _grad(loss, flat)

    if grad_accum <= 1:
        loss, metrics = forward(img, label_B)
        grads = list(backward(loss))
    else:
        mb = img.shape[0] // grad_accum
        grads, loss, metrics = None, 0.0, {k: 0.0 for k in METRICS}
        for i in range(grad_accum):
            sl = slice(i * mb, (i + 1) * mb)
            l_i, m_i = forward(img[sl], label_B[sl])
            g_i = backward(l_i)
            grads = list(g_i) if grads is None else [
                a + b for a, b in zip(grads, g_i)]
            loss = loss + l_i.detach()
            metrics = {k: metrics[k] + m_i[k] for k in METRICS}
        grads = [g / grad_accum for g in grads]
        loss = loss / grad_accum
        metrics = {k: v / grad_accum for k, v in metrics.items()}
    loss = loss.detach()
    if data_count() > 1:
        with span("data all-reduce"):
            grads = mean_over_data(grads)
            means = ("Lm", "Lt", "Accm", "Acct")
            red = mean_over_data([torch.stack([loss] + [metrics[k] for k in means])])[0]
            loss = red[0]
            metrics = dict(metrics, **{k: red[i + 1] for i, k in enumerate(means)})
    with span("optimizer"):
        it = iter(grads)
        grads = tree_map(lambda _: next(it), state.params)
        gnorm = global_norm(grads, layout)
        params, opt_state = apply_optimizer(state.params, grads,
                                            state.opt_state, lr, wd, clip,
                                            optimizer, layout)
    dev = gnorm.device
    metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                   lr=torch.tensor(lr, dtype=torch.float32, device=dev),
                   wd=torch.tensor(wd, dtype=torch.float32, device=dev))
    return TrainState(params, opt_state, state.step + 1), metrics


@torch.no_grad()
def eval_step(var_cfg: VARConfig, vae_cfg: VQVAEConfig, params: Dict,
              vae_params: Dict, img: torch.Tensor, label_B: torch.Tensor,
              dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Eval sums for one batch: mean and last-scale CE (no smoothing) and
    accuracies, each times the batch size, and ``tot`` (the batch size).
    On a mesh, sums over this rank's rows: the caller adds them up over
    the ranks (``parallel.distributed.allreduce_host``; the model ranks of
    a data index hold the same sums, which scale the totals and ``tot``
    alike)."""
    _, gt_BL, x_in = tokenize(var_cfg, vae_cfg, vae_params, img)
    logits = var_train_forward(var_cfg, params, label_B, x_in, dtype=dtype)
    ce = _ce_with_smoothing(logits, gt_BL, 0.0)
    last_l = var_cfg.patch_nums[-1] ** 2
    pred = logits.argmax(dim=-1)
    B = img.shape[0]
    return {
        "L_mean": ce.mean() * B,
        "L_tail": ce[:, -last_l:].mean() * B,
        "acc_mean": (pred == gt_BL).float().mean() * 100 * B,
        "acc_tail": (pred[:, -last_l:] == gt_BL[:, -last_l:]).float().mean()
        * 100 * B,
        "tot": torch.tensor(float(B), device=logits.device),
    }

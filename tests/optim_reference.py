"""The port's optimizer step as it was computed out of place, every result a
new tensor beside the old: global-norm clipping, Adam and the factored RMS
(optax's arithmetic), the decoupled weight decay and the learning rate,
the VQVAE's and the benchmark's SGD. The tests hold the in-place step
(``sdvar_tpu_torch/train/trainer.py``) against it bit for bit. One
process, no mesh; torch only, so that the tests on the card import it
too."""

import torch

from sdvar_tpu_torch.train import trainer as T


def clip_by_global_norm(grads, max_norm, norm):
    if max_norm <= 0:
        return grads
    small = norm < max_norm
    return T.tree_map(lambda g: torch.where(small, g, (g / norm) * max_norm),
                      grads)


def adam_update(grads, opt_state):
    count = opt_state["count"] + 1
    mu = T.tree_map(lambda g, m: (1 - T.ADAM_B1) * g + T.ADAM_B1 * m,
                    grads, opt_state["mu"])
    nu = T.tree_map(lambda g, v: (1 - T.ADAM_B2) * (g * g) + T.ADAM_B2 * v,
                    grads, opt_state["nu"])
    c = count.to(torch.float32)
    bc1 = 1 - torch.tensor(T.ADAM_B1, dtype=torch.float32) ** c
    bc2 = 1 - torch.tensor(T.ADAM_B2, dtype=torch.float32) ** c

    def direction(m, v):
        m_hat = m / bc1.to(m.device)
        v_hat = v / bc2.to(v.device)
        return m_hat / (torch.sqrt(v_hat) + T.ADAM_EPS)

    return T.tree_map(direction, mu, nu), {"count": count, "mu": mu, "nu": nu}


def factored_rms_update(grads, opt_state):
    t = (opt_state["count"] + 1).to(torch.float32)
    decay = 1.0 - t ** torch.tensor(-T.FACTORED_DECAY, dtype=torch.float32)

    def one(g, vr, vc, v):
        d = decay.to(g.device)
        dims = T._factored_dims(tuple(g.shape))
        g2 = g * g + T.FACTORED_EPS
        if dims is None:
            nv = d * v + (1.0 - d) * g2
            return g * nv ** -0.5, vr, vc, nv
        d1, d0 = dims
        nvr = d * vr + (1.0 - d) * g2.mean(dim=d0)
        nvc = d * vc + (1.0 - d) * g2.mean(dim=d1)
        rd1 = d1 - 1 if d1 > d0 else d1
        row_factor = (nvr / nvr.mean(dim=rd1, keepdim=True)) ** -0.5
        col_factor = nvc ** -0.5
        u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        return u, nvr, nvc, v

    out = T.tree_map(one, grads, opt_state["v_row"], opt_state["v_col"],
                     opt_state["v"])
    state = {"count": opt_state["count"] + 1, "v_row": T._pick(out, 1),
             "v_col": T._pick(out, 2), "v": T._pick(out, 3)}
    return T._pick(out, 0), state


def apply_optimizer(params, grads, opt_state, lr, wd, clip=2.0, kind="adamw",
                    norm=None):
    """(new params, new optimizer state); the given trees left as they
    were."""
    if clip > 0:
        grads = clip_by_global_norm(
            grads, clip, T.global_norm(grads) if norm is None else norm)
    fn = adam_update if kind == "adamw" else factored_rms_update
    u, opt_state = fn(grads, opt_state)
    mask = T.decay_mask(params)

    def step(p, d, m):
        lr_t = torch.tensor(lr, dtype=torch.float32, device=p.device)
        wd_t = torch.tensor(wd, dtype=torch.float32, device=p.device)
        return p + (-lr_t) * (d + wd_t * p * float(m))

    return T.tree_map(step, params, u, mask), opt_state


def accumulate(micro_grads):
    """The micro-batches' gradients summed, then averaged."""
    grads = list(micro_grads[0])
    for g_i in micro_grads[1:]:
        grads = [a + b for a, b in zip(grads, g_i)]
    n = len(micro_grads)
    return grads if n == 1 else [g / n for g in grads]


def sgd(params, grads, lr):
    """``p - lr * g``, lr a Python float (``tools/bench_train``'s step) or
    an f32 tensor (the VQVAE trainer's)."""
    it = iter(grads)
    if isinstance(lr, torch.Tensor):
        return T.tree_map(lambda p: p - lr.to(p.device) * next(it), params)
    return T.tree_map(lambda p: p - lr * next(it), params)

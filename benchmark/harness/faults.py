"""Faults planted in the port underneath a run, each of a kind a cell can
have, to show that the check catches it: a step that returns its state
unchanged, half of the batch left out (its outputs taken from the other
half), and a token or an answer altered where it is produced. Used by the
CPU tests and by ``calibrate.py --fault`` on the card; never by a
benchmark run.

Each fault is ``fault(patch)``, ``patch(obj, name, value)`` replacing an
attribute (pytest's ``monkeypatch.setattr``, or ``Patcher`` here)."""

from __future__ import annotations

import torch


class Patcher:
    """``patch(obj, name, value)``; ``undo()`` restores every attribute."""

    def __init__(self):
        self.saved = []

    def __call__(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved.clear()


# -- generation (drivers fid and serve) --------------------------------------

def gen_state_unchanged(patch):
    """The residual-VQ state update returns f_hat unchanged."""
    from sdvar_tpu_torch.models import quantizer as Q

    def unchanged(cfg, params, si, f_hat, h):
        nxt = cfg.patch_nums[min(si + 1, len(cfg.patch_nums) - 1)]
        return f_hat, torch.zeros(f_hat.shape[:2] + (nxt, nxt),
                                  device=f_hat.device)

    patch(Q, "next_autoregressive_input", unchanged)


def gen_half_batch(patch):
    """The second half of a batch's f_hat rows taken from the first half."""
    from sdvar_tpu_torch import sample_fid
    from sdvar_tpu_torch.engine import decode as D

    orig = D.decode_all_scales

    def half(*a, **k):
        f_hat, cache = orig(*a, **k)
        n = f_hat.shape[0] // 2
        return torch.cat([f_hat[:n], f_hat[:f_hat.shape[0] - n]]), cache

    patch(sample_fid, "decode_all_scales", half)   # the FID entry's name
    patch(D, "decode_all_scales", half)            # the server's


def gen_token_altered(patch):
    """Each row's first token of every scale moved to the next id."""
    from sdvar_tpu_torch.engine import decode as D

    orig = D.sample_with_top_k_top_p

    def altered(logits, *a, **k):
        ids = orig(logits, *a, **k).clone()
        ids[:, 0] = (ids[:, 0] + 1) % logits.shape[-1]
        return ids

    patch(D, "sample_with_top_k_top_p", altered)


def gen_answer_altered(patch):
    """A 64 x 64 corner of every delivered image brightened by 0.5."""
    from sdvar_tpu_torch import sample_fid
    from sdvar_tpu_torch.models import vqvae as VQ

    def altered(fn):
        def decode(cfg, p, f, *a, **k):
            img = fn(cfg, p, f, *a, **k).clone()
            img[:, :, :64, :64] += 0.5
            return img
        return decode

    orig = sample_fid._pixel_decoder
    patch(sample_fid, "_pixel_decoder", lambda px: altered(orig(px)))
    patch(VQ, "fhat_to_img_nhwc", altered(VQ.fhat_to_img_nhwc))


# -- training (driver train) -------------------------------------------------

def train_state_unchanged(patch):
    """The optimizer leaves the parameters and its state as they were."""
    from sdvar_tpu_torch.train import trainer as T

    patch(T, "apply_optimizer",
          lambda params, grads, opt, *a, **k: (params, opt))


def train_half_batch(patch):
    """The loss, and so the gradients, over the first half of the rows."""
    from sdvar_tpu_torch.train import trainer as T

    orig = T.loss_and_metrics

    def half(cfg, params, label_B, x_in, gt_BL, *a, **k):
        n = label_B.shape[0] // 2
        return orig(cfg, params, label_B[:n], x_in[:n], gt_BL[:n], *a, **k)

    patch(T, "loss_and_metrics", half)


def train_answer_altered(patch):
    """The head's weights moved double each step."""
    from sdvar_tpu_torch.train import trainer as T

    orig = T.apply_optimizer

    def double(params, grads, opt, *a, **k):
        before = params["head"]["w"].clone()
        out = orig(params, grads, opt, *a, **k)
        params["head"]["w"].add_(params["head"]["w"] - before)
        return out

    patch(T, "apply_optimizer", double)


GENERATION = {"state_unchanged": gen_state_unchanged,
              "half_batch": gen_half_batch,
              "token_altered": gen_token_altered,
              "answer_altered": gen_answer_altered}
TRAINING = {"state_unchanged": train_state_unchanged,
            "half_batch": train_half_batch,
            "answer_altered": train_answer_altered}


def for_driver(driver: str):
    return TRAINING if driver == "train" else GENERATION

"""Driver ``train``: VAR training from images through the port's
``sdvar_tpu_torch.train.train_step``, one global batch a step (f32 tokenize
inside the step, bf16 forward, f32 master weights, AdamW in place, the
recipe's lr, weight decay, clip and label smoothing, no remat,
``grad_accum`` 1), each step on its own rows of an image pool that set-up
draws on the card, with its own seeded training draws.

Set-up builds the one training state and drives it through the check's
first three steps with the window's own call and feed; the window then
takes that state on, step after step, each step synchronised on its loss,
and ends at the first step boundary at or after ``--seconds``.
``train_img_per_s`` is the images of all its steps over all its time.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import torch

from benchmark.harness import cells, weights
from benchmark.harness.trace import Tracer
from benchmark.harness.window import rate, step_window
from benchmark.reference import train as RT
from benchmark.reference.precision import CONTROL_BF16, EXACT

CHECK_STEPS = 3
METRIC = "train_img_per_s"  # the end-to-end metric of its window, beside setup_s


def _norms(tree_items) -> Dict[str, float]:
    return {p: float(t.double().norm()) for p, t in tree_items}


class Run:
    def __init__(self, cell: Dict, seed: int, device):
        from sdvar_tpu_torch.train import trainer as T
        from sdvar_tpu_torch.utils.profiling import SpanTimer

        self.T, self.SpanTimer = T, SpanTimer
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        self.model, self.tr = cell["model"], cell["traffic"]
        self.rec = self.model["train"]
        self.var_cfg = cells.var_config(self.model)
        self.vae_cfg = cells.vqvae_config(self.model)
        self.B = self.rec["global_batch_size"]
        parts, t = {}, time.time()
        params = weights.var_params(self.model["var"], seed, self.dev,
                                    torch.float32)
        self.vae = weights.vqvae_params(self.model["vqvae"], seed, self.dev)
        n = self.tr["pool_images"]
        self.pool = weights.images(n, self.tr["reso"], seed, self.dev)
        self.pool_labels = weights.labels(n, self.var_cfg.num_classes, seed,
                                          self.dev)
        # the benchmark's weights as made, for the reference
        self.init = {p: t.clone() for p, t in T.tree_leaves(params)}
        self.state = T.init_train_state(params, "adamw")
        self._sync()
        parts["weights_s"] = time.time() - t
        t = time.time()
        self.k, self.losses, self.spans_timer = 0, [], None
        for i in range(CHECK_STEPS):
            self.losses.append(self.step())
            if i == 0:
                mu = self.state.opt_state["mu"]
                self.grad1 = {p: v / (1 - RT.B1)
                              for p, v in _norms(T.tree_leaves(mu)).items()}
        self.change3 = _norms((p, t - self.init[p])
                              for p, t in T.tree_leaves(self.state.params))
        self._sync()
        parts["first_steps_s"] = time.time() - t
        self.parts = parts
        self.steps = 0

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def batch(self, k: int):
        n = self.pool.shape[0]
        r0 = (k * self.B) % n
        return self.pool[r0:r0 + self.B], self.pool_labels[r0:r0 + self.B]

    def step(self) -> float:
        """One training step; returns its loss (which waits for it)."""
        img, lab = self.batch(self.k)
        gen = weights.generator(self.seed, 100 + self.k, self.dev)
        self.state, m = self.T.train_step(
            self.var_cfg, self.vae_cfg, self.state, self.vae, img, lab,
            self.rec["peak_lr"], self.rec["weight_decay"], generator=gen,
            clip=self.rec["grad_clip"], label_smooth=self.rec["label_smooth"],
            timer=self.spans_timer)
        self.k += 1
        return float(m["loss"])

    def setup_parts(self) -> Dict[str, float]:
        return self.parts

    def window(self, seconds: float) -> Dict:
        got = step_window(self.step, seconds)
        self.steps = got["steps"]
        return {"train_img_per_s": {"value": rate(self.B * got["steps"],
                                                  got["elapsed"]),
                                    "unit": "img/s"}}

    def traced_window(self) -> Dict:
        self.spans_timer = self.SpanTimer(self.dev)
        tracer = Tracer(self.dev)
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        tracer.start()
        for _ in range(self.tr["trace_steps"]):
            self.step()
        tr = tracer.stop()
        self.steps = self.tr["trace_steps"]
        spans = self.spans_timer.report()
        self.spans_timer = None
        return {"trace": tr, "steps": self.steps, "batch": self.B,
                "spans": spans,
                "peak_window_bytes": (torch.cuda.max_memory_allocated(self.dev)
                                      if self.dev.type == "cuda" else None)}

    def summary(self) -> Dict[str, int]:
        return {"attempted": self.steps + CHECK_STEPS, "failed": 0}

    def release(self) -> None:
        self.state = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, prec) -> Dict:
        """The reference's three steps from the benchmark's weights on the
        same rows and draws: losses, the first gradient's leaf norms as
        AdamW took it, the leaves' change norms after the three."""
        params = {p: t.clone().requires_grad_(True) for p, t in self.init.items()}
        tree = _tree(params)
        state, losses = {}, []
        for k in range(CHECK_STEPS):
            img, lab = self.batch(k)
            gen = weights.generator(self.seed, 100 + k, self.dev)
            loss, grads = RT.loss_and_grads(self.model, tree, self.vae, img,
                                            lab, gen, self.rec["label_smooth"],
                                            prec)
            took = RT.adamw(tree, grads, state, self.rec["peak_lr"],
                            self.rec["weight_decay"], self.rec["grad_clip"])
            losses.append(loss)
            if k == 0:
                grad1 = _norms(took.items())
            del grads, took
        change = _norms((p, t.detach() - self.init[p]) for p, t in params.items())
        return {"losses": losses, "grad1": grad1, "change3": change}

    def readings(self, control: bool = False) -> Dict[str, float]:
        if getattr(self, "_ref", None) is None:
            self._ref = self._reference(EXACT)
        ref = self._ref
        got = self._reference(CONTROL_BF16) if control else {
            "losses": self.losses, "grad1": self.grad1, "change3": self.change3}
        return compare(ref, got)

    def check(self):
        self.release()
        got = self.readings()
        lim = self.cell["limits"]
        return [(k, got[k], lim[k]) for k in ("loss_err", "grad_err",
                                             "update_err")]


def _tree(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for path, t in flat.items():
        node = tree
        *heads, leaf = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = t
    return tree


def compare(ref: Dict, got: Dict, moved: float = 1e-3) -> Dict[str, float]:
    """The numbers compared, each by its worst case:

    - ``loss_err``: the largest relative gap of a step's loss;
    - ``grad_err``: the largest gap between a leaf's first-gradient norm
      and the reference's, over the larger of the reference's norm of that
      leaf and of the median leaf;
    - ``update_err``: the same for the norm of a leaf's change over the
      three steps, over the leaves whose reference gradient reaches
      ``moved`` times the median leaf's (a leaf whose gradient is nought to
      rounding moves under Adam by round-off alone).
    """
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    gmed = statistics.median(ref["grad1"].values())
    cmed = statistics.median(ref["change3"].values())
    grad_err = max(abs(got["grad1"][p] - g) / max(g, gmed)
                   for p, g in ref["grad1"].items())
    counted: List[float] = [
        abs(got["change3"][p] - c) / max(c, cmed)
        for p, c in ref["change3"].items() if ref["grad1"][p] >= moved * gmed]
    return {"loss_err": loss_err, "grad_err": grad_err,
            "update_err": max(counted)}


def setup(cell: Dict, seed: int, device) -> Run:
    return Run(cell, seed, device)

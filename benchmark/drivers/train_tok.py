"""Driver ``train_tok``: the ``train`` driver (``drivers/train.py``: its
recipe, draws, window, traced window and check, taken by import) on stored
token ids instead of images, as a team trains that tokenized its data set
once (the port's ``tools/pretokenize``).

Set-up tokenizes the cell's image pool once, with the port's f32
``trainer.tokenize``, into (pool, L) ids, and drops the images; each step
then calls ``train_step(..., pretokenized=True)`` on its own rows of ids,
so the step runs no encoder and no quantizer encode. The reference
(``reference/train_tok.py``) trains on the same stored ids. The cell's
traffic says ``pretokenized``; set-up refuses a cell that does not.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from benchmark.harness import cells, weights
from benchmark.reference import train_tok as RTT

METRIC = "train_img_per_s"  # the end-to-end metric of its window, beside setup_s

# this module's own copy of the train driver (``cells.driver`` loads the
# file anew), whose reference trains on the stored ids
_train = cells.driver("train")
_train.RT = RTT


class Run(_train.Run):
    ids = None

    def _tokenize_pool(self) -> None:
        """The pool's ids, (pool, L) int64, a step's batch at a time; the
        images are dropped after."""
        t = time.time()
        chunks = [self.T.tokenize(self.var_cfg, self.vae_cfg, self.vae,
                                  self.pool[r0:r0 + self.B])[1]
                  for r0 in range(0, self.pool.shape[0], self.B)]
        self.ids = torch.cat(chunks)
        self.pool = None
        self._sync()
        self.tokenize_s = time.time() - t

    def batch(self, k: int):
        # the pool is tokenized at the first batch: the train driver's
        # set-up takes its first steps before a subclass could act
        if self.ids is None:
            self._tokenize_pool()
        n = self.ids.shape[0]
        r0 = (k * self.B) % n
        return self.ids[r0:r0 + self.B], self.pool_labels[r0:r0 + self.B]

    def step(self) -> float:
        """One training step on stored ids; returns its loss (which waits
        for it)."""
        ids, lab = self.batch(self.k)
        gen = weights.generator(self.seed, 100 + self.k, self.dev)
        self.state, m = self.T.train_step(
            self.var_cfg, self.vae_cfg, self.state, self.vae, ids, lab,
            self.rec["peak_lr"], self.rec["weight_decay"], generator=gen,
            clip=self.rec["grad_clip"], label_smooth=self.rec["label_smooth"],
            pretokenized=True, timer=self.spans_timer)
        self.k += 1
        return float(m["loss"])

    def setup_parts(self) -> Dict[str, float]:
        """``first_steps_s`` includes the pool's tokenization,
        ``tokenize_s``."""
        return dict(self.parts, tokenize_s=self.tokenize_s)


def setup(cell: Dict, seed: int, device) -> Run:
    if not cell["traffic"].get("pretokenized"):
        raise ValueError(f"cell {cell.get('name')!r}: the train_tok driver "
                         "trains on stored ids (traffic pretokenized: true)")
    return Run(cell, seed, device)

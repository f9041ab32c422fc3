"""The port's VAR with shared AdaLN (VAR's ``--saln=1`` models, as VAR-d36
512px) and with per-layer AdaLN, held against the benchmark's plain
reference (``benchmark/reference/shared_aln.py`` over
``benchmark/reference/var.py``) on the CPU: a depth-2, width-128 model,
on the 512px pattern's first 7 scales and on the 256px pattern, with the
benchmark's weights (``drivers/fid_saln.py:var_params``, every block's
gammas of order 0.5) in float32, on one intra-op thread.

- the teacher-forced forward's logits;
- ``sample_fid.sample_batches`` (the FID entry point) end to end: the
  logits each token was drawn from against the reference's teacher-forced
  logits over the served tokens, every token the sampling rule's pick
  (``sample_gap`` 0), and the delivered pixels against the reference's
  decode of the served tokens;
- the e4m3 control (the reference's blocks one precision below bf16 in
  the port's place) exceeds the logit limit, so the limit can tell.

Limits, float32 against float32: the two sides sum in other orders (the
port's GEMMs, its L2 norms and softmax, the shared projection's sum
before ``ada_gss`` is added), each sum rounded to 2^-24 of its size, over
2 blocks whose gammas are of order 0.5, then a head of width 128 that
makes logits of a standard deviation of about 2. The largest differences
seen on these cases: 3.3e-6 to 3.8e-6 for the teacher-forced logits,
1.0e-5 to 1.6e-5 for the CFG-mixed ones (the mix takes up to 2.5 times
the conditional row and 1.5 times the unconditional one), 1.1e-6 to
1.6e-6 for the pixels ([0, 1] units: the same f32 decoder on both sides,
fed f_hat rebuilt from the same ids). ``LOGIT_TOL`` 2e-4 is 12 times the
largest and 6,000 times below what the e4m3 control reads (1.33 to
1.51); ``PIXEL_TOL`` 1e-5 is 6 times the largest.
"""

import copy

import numpy as np
import pytest
import torch

from benchmark.harness import cells, gencheck, weights
from benchmark.reference import quantizer as RQ
from benchmark.reference import shared_aln as RSA
from benchmark.reference.precision import CONTROL_BF16
from benchmark.tests import tiny
from sdvar_tpu_torch import sample_fid
from sdvar_tpu_torch.config import PATCH_NUMS_256, PATCH_NUMS_512, SamplingConfig
from sdvar_tpu_torch.engine import decode as D
from sdvar_tpu_torch.models import var as M

LOGIT_TOL = 2e-4
PIXEL_TOL = 1e-5
PATTERNS = {"512-first7": list(PATCH_NUMS_512[:7]), "256": list(PATCH_NUMS_256)}
CASES = [(shared, pat) for shared in (True, False) for pat in PATTERNS]
IDS = [f"{'shared' if s else 'per-layer'}-{p}" for s, p in CASES]
BATCH, IMAGES, SEED = 4, 8, 2 ** 31 + 77


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model(shared: bool, pattern: str) -> dict:
    m = copy.deepcopy(tiny.MODEL)
    pns = PATTERNS[pattern]
    m["var"].update(depth=2, embed_dim=128, num_heads=2, head_dim=64,
                    mlp_hidden=512, patch_nums=pns, vocab_size=256,
                    L=sum(p * p for p in pns), shared_aln=shared)
    m["vqvae"]["vocab_size"] = 256
    return m


def draw(m: dict, seed: int):
    """The benchmark's weights for the model, float32 on the CPU."""
    var = m["var"]
    if var["shared_aln"]:
        p = cells.driver("fid_saln").var_params(var, seed, "cpu", torch.float32)
    else:
        p = weights.var_params(var, seed, "cpu", torch.float32)
    return p, weights.vqvae_params(m["vqvae"], seed, "cpu")


@pytest.mark.parametrize("shared, pattern", CASES, ids=IDS)
def test_teacher_forced_forward(shared, pattern):
    m = model(shared, pattern)
    var = m["var"]
    p, vae = draw(m, 5)
    assert ("shared_ada_lin" in p) == shared
    g = torch.Generator().manual_seed(6)
    ids = [torch.randint(0, var["vocab_size"], (6, pn * pn), generator=g)
           for pn in var["patch_nums"]]
    labels = torch.tensor([0, 3, 9, 10, 2, 10])  # 10: the unconditional class
    _, inputs = RQ.fhat_from_ids(m["vqvae"], vae["quant"], var["patch_nums"],
                                 ids)
    got = M.var_train_forward(cells.var_config(m), p, labels,
                              torch.cat(inputs, 1), dtype=torch.float32)
    want = RSA.forward(var, p, labels, inputs)
    assert got.shape == want.shape == (6, var["L"], var["vocab_size"])
    assert want.std() > 0.5
    assert (got - want).abs().max() <= LOGIT_TOL


@pytest.fixture(scope="module")
def sampled():
    """Per case: the weights, and what ``sample_batches`` served and
    delivered for ``IMAGES`` images in f32 (held by the benchmark's
    recorder around the decode's sampler call)."""
    out = {}
    for shared, pattern in CASES:
        m = model(shared, pattern)
        p, vae = draw(m, 8)
        var_cfg, vae_cfg = cells.var_config(m), cells.vqvae_config(m)
        s = m["sampling"]
        samp = SamplingConfig(cfg=s["cfg"], top_k=s["top_k"], top_p=s["top_p"])
        labels = np.arange(IMAGES) % (var_cfg.num_classes + 1)
        rec = gencheck.Recorder(D, var_cfg.num_scales, IMAGES // BATCH, SEED)
        rec.on = True
        try:
            images = list(sample_fid.sample_batches(
                var_cfg, vae_cfg, p, vae, labels, BATCH, samp,
                dtype=torch.float32, kv_mode="f32", seed0=SEED, log_every=0,
                pixels="f32", device="cpu"))
        finally:
            rec.restore()
        nb = IMAGES // BATCH
        ids = [torch.cat([rec.batch_ids(b)[si] for b in range(nb)])
               for si in range(var_cfg.num_scales)]
        logits = [torch.cat([rec.logits[b][si] for b in range(nb)])
                  for si in range(var_cfg.num_scales)]
        out[(shared, pattern)] = (m, p, vae, labels, ids, logits,
                                  np.concatenate(images))
    return out


def judge(case, control=False):
    m, p, vae, labels, ids, logits, images = case
    return gencheck.judge(m, m["sampling"], RSA.per_layer_view(m["var"], p),
                          vae, [int(x) for x in labels],
                          [SEED + i for i in range(IMAGES)], ids, logits,
                          images, "cpu", control=control,
                          var_control=CONTROL_BF16)


@pytest.mark.parametrize("shared, pattern", CASES, ids=IDS)
def test_sample_batches_against_the_reference(sampled, shared, pattern):
    case = sampled[(shared, pattern)]
    assert len(case[4]) == len(PATTERNS[pattern])
    got = judge(case)
    assert got["logit_err"] <= LOGIT_TOL, got
    assert got["sample_gap"] == 0.0, got
    assert got["pixel_err"] <= PIXEL_TOL, got


@pytest.mark.parametrize("shared, pattern", CASES, ids=IDS)
def test_e4m3_control_exceeds_the_limits(sampled, shared, pattern):
    got = judge(sampled[(shared, pattern)], control=True)
    assert got["logit_err"] > 100 * LOGIT_TOL, got

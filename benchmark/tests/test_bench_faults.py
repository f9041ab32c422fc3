"""Runs of the harness on the CPU at the tiny configuration (the look for
a card skipped), with the timed path broken underneath by each fault of
``harness/faults.py`` that the cell can have: ``correct`` has to come out
false; the same run unbroken comes out true. (No cell spans chips, so the
exchange between chips has no fault here.)"""

import io
import json
import time
from contextlib import redirect_stdout

import pytest

from benchmark.harness import faults, runner
from benchmark.tests import tiny


def run(cell, seed=11):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = runner.run_loaded(cell, seed, 0.3, False, time.time(),
                               require_card=False, device="cpu")
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", [tiny.FID, tiny.SERVE, tiny.TRAIN,
                                  tiny.FID_W8A8],
                         ids=["fid", "serve", "train", "fid-w8a8"])
def test_sound_run_is_correct(cell):
    assert run(cell)["correct"] is True


CASES = [(c, f) for c in (tiny.FID, tiny.SERVE, tiny.FID_W8A8)
         for f in faults.GENERATION] \
    + [(tiny.TRAIN, f) for f in faults.TRAINING]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c['name']}-{f}" for c, f in CASES])
def test_fault_is_caught(monkeypatch, cell, fault):
    faults.for_driver(cell["driver"])[fault](monkeypatch.setattr)
    assert run(cell)["correct"] is False

"""The control, the reference one precision lower in the program's place,
has to come out as not correct, while the program does: on the CPU at the
tiny configuration, and on the card at each cell's own size and limits
(``gpu``: the chip run of ``benchmark/calibrate.py`` reads the same)."""

import pytest
import torch

from benchmark.harness import cells
from benchmark.tests import tiny

CELLS = ["d30-256.fid-bf16-b32", "d16-256.train-b32",
         "d30-256.serve-bf16-open", "d30-256.fid-w8a8kv8-b32"]


def readings(cell, seed, device, seconds):
    run = cells.driver(cell["driver"]).setup(cell, seed, device)
    run.window(seconds if cell["driver"] != "serve" else 5 * seconds)
    run.release()
    return run.readings(), run.readings(control=True)


def fails(got, limits):
    return [k for k, v in got.items() if v > limits[k]]


@pytest.mark.parametrize("cell", [tiny.FID, tiny.TRAIN, tiny.SERVE,
                                  tiny.FID_W8A8],
                         ids=["fid", "train", "serve", "fid-w8a8"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_on_cpu(cell, seed):
    program, control = readings(cell, seed, "cpu", 0.2)
    assert not fails(program, cell["limits"]), program
    assert fails(control, cell["limits"]), control


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's own size runs there")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(card, name):
    cell = cells.workload(name)
    program, control = readings(cell, 4242, "cuda", 5.0)
    assert not fails(program, cell["limits"]), program
    assert fails(control, cell["limits"]), control

"""The drivers ``fid_saln`` (a VAR with shared AdaLN through the FID
pipeline) and ``train_tok`` (training on stored ids) on the CPU at tiny
cells: a sound run is correct and reports its per-layer metrics, the
control (the reference one precision lower in the program's place) fails
while the program passes, and each fault of ``harness/faults.py`` that
the cell can have makes ``correct`` false. Marked ``gpu``: the same at
each cell's own size on the card."""

import copy
import io
import json
import time
from contextlib import redirect_stdout

import pytest
import torch

from benchmark.harness import cells, faults, runner
from benchmark.tests import tiny

SALN_MODEL = copy.deepcopy(tiny.MODEL)
SALN_MODEL["var"]["shared_aln"] = True
SALN = {"name": "tiny.fid-saln", "config": "tiny-saln", "driver": "fid_saln",
        "chips": 1, "why": "test", "model": SALN_MODEL,
        "traffic": dict(tiny.FID["traffic"], pixels="bf16"),
        "limits": {"logit_err": 0.2, "sample_gap": 1e-3, "pixel_mae": 0.01}}
TOK = {"name": "tiny.train-tok", "config": "tiny", "driver": "train_tok",
       "chips": 1, "why": "test", "model": tiny.MODEL,
       "traffic": dict(tiny.TRAIN["traffic"], pretokenized=True),
       "limits": tiny.TRAIN["limits"]}
CELLS = ["d36-512.fid-bf16-b16", "d16-256.train-tok-b32"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(cell, trace=False, seed=11):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = runner.run_loaded(cell, seed, 0.3, trace, time.time(),
                               require_card=False, device="cpu")
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def readings(cell, seed, device, seconds):
    r = cells.driver(cell["driver"]).setup(cell, seed, device)
    r.window(seconds)
    r.release()
    return r.readings(), r.readings(control=True)


def fails(got, limits):
    return [k for k, v in got.items() if v > limits[k]]


def test_shared_aln_weights():
    """The draw holds the port's shared layout and no per-layer AdaLN."""
    var = SALN_MODEL["var"]
    p = cells.driver("fid_saln").var_params(var, 3, "cpu", torch.float32)
    C, depth = var["embed_dim"], var["depth"]
    assert p["shared_ada_lin"]["w"].shape == (C, 6 * C)
    assert p["shared_ada_lin"]["b"].shape == (6 * C,)
    assert p["blocks"]["ada_gss"].shape == (depth, 1, 6, C)
    assert not {"ada_lin_w", "ada_lin_b"} & set(p["blocks"])
    assert 0.3 < float(p["shared_ada_lin"]["b"][: 2 * C].std()) < 0.7


@pytest.mark.parametrize("cell, metrics", [
    (SALN, {"mfu.saln", "latent_ms_per_img.saln", "tail_ms_per_img.saln",
            "graph_share.saln"}),
    (TOK, {"mfu.train_tok"})], ids=["fid_saln", "train_tok"])
def test_sound_traced_run(cell, metrics):
    got = run(cell, trace=True)
    assert got["correct"] is True
    assert metrics <= set(got["metrics"])
    if cell is SALN:
        m = got["metrics"]
        assert 0 < m["tail_ms_per_img.saln"]["value"] \
            < m["latent_ms_per_img.saln"]["value"]


def test_refuses_a_cell_with_images():
    cell = copy.deepcopy(TOK)
    cell["traffic"]["pretokenized"] = False
    with pytest.raises(ValueError, match="pretokenized"):
        cells.driver("train_tok").setup(cell, 1, "cpu")


@pytest.mark.parametrize("cell", [SALN, TOK], ids=["fid_saln", "train_tok"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_on_cpu(cell, seed):
    program, control = readings(cell, seed, "cpu", 0.2)
    assert not fails(program, cell["limits"]), program
    assert fails(control, cell["limits"]), control


# (``faults.for_driver`` knows the drivers ``train`` and the generation
# ones by name: a ``train_tok`` cell takes the training faults)
CASES = [(SALN, faults.GENERATION, f) for f in faults.GENERATION] \
    + [(TOK, faults.TRAINING, f) for f in faults.TRAINING]


@pytest.mark.parametrize("cell,kind,fault", CASES,
                         ids=[f"{c['name']}-{f}" for c, _, f in CASES])
def test_fault_is_caught(monkeypatch, cell, kind, fault):
    kind[fault](monkeypatch.setattr)
    assert run(cell)["correct"] is False


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's own size runs there")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(card, name):
    cell = cells.workload(name)
    program, control = readings(cell, 4243, "cuda", 5.0)
    assert not fails(program, cell["limits"]), program
    assert fails(control, cell["limits"]), control


@pytest.mark.gpu
def test_token_fault_fails_on_the_card(card, monkeypatch):
    cell = cells.workload("d36-512.fid-bf16-b16")
    faults.gen_token_altered(monkeypatch.setattr)
    program, _ = readings(cell, 4244, "cuda", 5.0)
    assert "sample_gap" in fails(program, cell["limits"]), program

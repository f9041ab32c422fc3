"""The readers of the program's spans on the CPU: traced windows of the
tiny fid and serve cells, one after the other in one process, report the
five span metrics, each computed from that window's spans alone; and a
program without the span recorder leaves them out without raising."""

import io
import json
import time
from contextlib import redirect_stdout

import pytest
import torch

from benchmark.harness import cells, runner
from benchmark.harness.window import percentile_with_missing
from benchmark.tests import tiny
from sdvar_tpu_torch.utils import profiling

SPAN_METRICS = {"fid": ("dispatch_ms_per_img.gen", "latent_ms_per_img.gen",
                        "pixel_ms_per_img.gen"),
                "serve": ("queue_wait_ms.serve", "host_busy_share.serve")}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def traced(cell, seed):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = runner.run_loaded(cell, seed, 0.3, True, time.time(),
                               require_card=False, device="cpu")
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def total(spans, name, field="host_ms"):
    return sum(getattr(s, field) for s in spans if s.name == name)


def test_two_windows_each_read_their_own_spans():
    fid = traced(tiny.FID, 2 ** 31 + 21)
    fid_spans = profiling.spans()
    serve = traced(tiny.SERVE, 2 ** 31 + 22)
    serve_spans = profiling.spans()
    assert fid["correct"] and serve["correct"]
    for line, kind in ((fid, "fid"), (serve, "serve")):
        for name in SPAN_METRICS[kind]:
            assert line["metrics"][name]["value"] > 0, name

    images = fid["attempted"]
    batches = images // tiny.FID["traffic"]["batch"]
    assert len([s for s in fid_spans if s.name == "sdvar.fid.dispatch"]) \
        == batches == tiny.FID["traffic"]["trace_batches"]
    assert len([s for s in fid_spans if s.name == "sdvar.decode"]) == batches
    got = fid["metrics"]
    assert got["dispatch_ms_per_img.gen"]["value"] == pytest.approx(
        total(fid_spans, "sdvar.fid.dispatch") / images)
    assert got["latent_ms_per_img.gen"]["value"] == pytest.approx(
        total(fid_spans, "sdvar.decode", "device_ms") / images)
    assert got["pixel_ms_per_img.gen"]["value"] == pytest.approx(
        total(fid_spans, "sdvar.pixels", "device_ms") / images)
    assert got["latent_ms_per_img.gen"]["value"] \
        + got["pixel_ms_per_img.gen"]["value"] \
        <= got["dispatch_ms_per_img.gen"]["value"]

    # the serve window's record holds its own requests and nothing of fid's
    assert not [s for s in serve_spans if s.name.startswith("sdvar.fid.")]
    waits = [s.host_ms for s in serve_spans if s.name == "sdvar.serve.queue"]
    assert len(waits) == serve["attempted"]
    assert len({s.ids["rid"] for s in serve_spans
                if s.name == "sdvar.serve.queue"}) == len(waits)
    got = serve["metrics"]
    assert got["queue_wait_ms.serve"]["value"] == pytest.approx(
        percentile_with_missing(waits, 95))
    assert 0 < got["host_busy_share.serve"]["value"] <= 1


def test_readers_leave_a_program_without_spans_alone(monkeypatch):
    """The parent program has no ``spans``: each reader returns None."""
    monkeypatch.delattr(profiling, "spans")
    ctx = {"images": 8, "trace": type("T", (), {"window_s": 1.0})()}
    readers = {m.NAME: m for m in cells.metric_modules()}
    for names in SPAN_METRICS.values():
        for name in names:
            assert readers[name].read(ctx) is None, name

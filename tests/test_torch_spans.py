"""The port's span recorder (``utils.profiling.span`` / ``mark`` /
``spans``) on the CPU: nothing recorded and no profiler range made with no
profiler running; under ``torch.profiler`` spans nest, a thread started
before the profiler records, each span lines up with the profiler's own
event of its name, and a second recording does not mix with the first;
and the spans of the decode, the FID pipeline and the server, where the
work happens (``train_step``'s: ``tests/test_torch_debug_profiling.py``)."""

import threading
import time

import pytest
import torch

from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.engine import decode as D
from sdvar_tpu_torch.engine.serving import GenerationServer
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.sample_fid import sample_batches
from sdvar_tpu_torch.utils import profiling as P

PNS = (1, 2, 3)
VAR_KW = dict(depth=2, num_classes=10, patch_nums=PNS, vocab_size=64, Cvae=8,
              head_dim=32, cond_drop_rate=0.0, drop_path_rate=0.0)
VAE_KW = dict(vocab_size=64, z_channels=8, ch=32, patch_nums=PNS)
SAMP = SamplingConfig(cfg=1.5, top_k=8)
F32 = torch.float32


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the shapes are tiny and the suite's workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stack():
    var_cfg, vae_cfg = VARConfig(**VAR_KW), VQVAEConfig(**VAE_KW)
    return (var_cfg, vae_cfg, init_var_params(var_cfg, seed=0, device="cpu"),
            init_vqvae_params(vae_cfg, seed=0, device="cpu"))


class profiled:
    """``with profiled() as prof:`` a CPU ``torch.profiler`` recording."""

    def __enter__(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        self.prof.start()
        return self.prof

    def __exit__(self, *exc):
        self.prof.stop()


def named(spans, name):
    return [s for s in spans if s.name == name]


def test_no_profiler_no_record(monkeypatch):
    """Off: ``span`` is one shared no-op context, ``mark`` returns, and
    neither opens a profiler range, makes an event or adds a span."""
    before = P.spans()

    def forbidden(*a, **k):
        raise AssertionError("made while no profiler records")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    assert P.span("sdvar.a") is P.span("sdvar.b", si=1) is P.launch("sdvar.c")
    with P.span("sdvar.off", batch=3):
        torch.ones(4) + 1
    P.mark("sdvar.off.mark", 0, 10, rid=1)
    after = P.spans()
    assert [id(s) for s in after] == [id(s) for s in before]
    assert not named(after, "sdvar.off") and not named(after, "sdvar.off.mark")


def test_spans_nest_with_their_parent():
    with profiled():
        with P.span("sdvar.outer", batch=2) as outer:
            with P.span("sdvar.inner", si=0):
                with P.span("sdvar.innermost", si=1):
                    pass
            with P.span("sdvar.inner", si=1):
                with P.launch("sdvar.launch.k"):
                    pass
            P.mark("sdvar.crossing", outer.start_ns, time.perf_counter_ns(),
                   rid=5)
        with P.span("sdvar.after"):
            pass
    got = P.spans()
    by = {(s.name, s.ids.get("si")): s for s in got}
    root = by[("sdvar.outer", None)]
    assert root.parent is None and root.ids == {"batch": 2}
    assert by[("sdvar.inner", 0)].parent == root.index
    assert by[("sdvar.inner", 1)].parent == root.index
    assert by[("sdvar.innermost", 1)].parent == by[("sdvar.inner", 0)].index
    assert by[("sdvar.crossing", None)].parent == root.index
    assert by[("sdvar.crossing", None)].ids == {"rid": 5}
    assert by[("sdvar.crossing", None)].device_ms is None   # a mark
    assert by[("sdvar.after", None)].parent is None
    assert by[("sdvar.launch.k", None)].parent == by[("sdvar.inner", 1)].index
    for s in got:
        assert s.end_ns >= s.start_ns and s.thread == threading.get_ident()
        if s.name != "sdvar.crossing":   # on the CPU: the host time
            assert s.device_ms == pytest.approx(s.host_ms)
    inner = by[("sdvar.inner", 0)]
    assert root.start_ns <= inner.start_ns <= inner.end_ns <= root.end_ns


def test_thread_started_before_the_profiler_records():
    go, done = threading.Event(), threading.Event()

    def work():
        go.wait(timeout=30)
        with P.span("sdvar.worker", rid=9):
            time.sleep(0.002)
        done.set()

    th = threading.Thread(target=work, daemon=True)
    th.start()
    with profiled():
        go.set()
        assert done.wait(timeout=30)
    th.join(timeout=30)
    assert not th.is_alive()
    got = named(P.spans(), "sdvar.worker")
    assert len(got) == 1 and got[0].ids == {"rid": 9}
    assert got[0].thread != threading.get_ident() and got[0].host_ms >= 2.0


def test_spans_line_up_with_the_profiler_events():
    """Each span has the profiler's host event of its name: the span's
    start mapped onto the profiler's clock within 2 ms of the event's, its
    length within 10% or 1 ms of the event's."""
    with profiled() as prof:
        for i in range(3):
            with P.span(f"sdvar.lined.{i}"):
                torch.ones(128, 128) @ torch.ones(128, 128)
                time.sleep(0.003 * (i + 1))
    got = [s for s in P.spans() if s.name.startswith("sdvar.lined.")]
    assert len(got) == 3
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for s in got:
        e = events[s.name]
        assert abs(s.unix_start_ns - e.start_ns()) <= 2e6, s.name
        ev_ms = e.duration_ns() / 1e6
        assert abs(s.host_ms - ev_ms) <= max(0.1 * ev_ms, 1.0), s.name


def test_a_new_recording_does_not_mix_with_the_last():
    with profiled():
        with P.span("sdvar.first"):
            pass
    assert [s.name for s in P.spans()] == ["sdvar.first"]
    assert [s.name for s in P.spans()] == ["sdvar.first"]  # read again
    with profiled():
        with P.span("sdvar.second"):
            pass
        P.mark("sdvar.second.mark", 1, 2)
    assert [s.name for s in P.spans()] == ["sdvar.second", "sdvar.second.mark"]


def test_decode_spans_a_scale_each(stack):
    var_cfg, vae_cfg, vp, qp = stack
    with profiled():
        D.decode_all_scales(var_cfg, vae_cfg, vp, qp["quant"], [1, 2], [3, 4],
                            SAMP, F32, device="cpu")
    got = P.spans()
    decode = named(got, "sdvar.decode")
    scales = named(got, "sdvar.decode.scale")
    assert len(decode) == 1
    assert [s.ids["si"] for s in scales] == list(range(var_cfg.num_scales))
    assert all(s.parent == decode[0].index for s in scales)
    assert all(a.end_ns <= b.start_ns for a, b in zip(scales, scales[1:]))


def test_sample_batches_spans_a_batch(stack):
    """Two batches (4 + 2 images): a dispatch, a pixel decode under it, a
    backpressure wait and a materialize each, named by the batch's
    offset."""
    var_cfg, vae_cfg, vp, qp = stack
    with profiled():
        imgs = list(sample_batches(var_cfg, vae_cfg, vp, qp, [1, 2, 3, 4, 5, 6],
                                   4, SAMP, dtype=F32, kv_mode="f32",
                                   log_every=0, device="cpu"))
    assert [len(b) for b in imgs] == [4, 2]
    got = P.spans()
    dispatch = named(got, "sdvar.fid.dispatch")
    assert [s.ids["batch"] for s in dispatch] == [0, 4]
    pixels = named(got, "sdvar.pixels")
    assert [s.ids["batch"] for s in pixels] == [0, 4]
    assert [s.parent for s in pixels] == [s.index for s in dispatch]
    assert [s.parent for s in named(got, "sdvar.decode")] \
        == [s.index for s in dispatch]
    for name in ("sdvar.fid.backpressure", "sdvar.fid.materialize"):
        assert sorted(s.ids["batch"] for s in named(got, name)) == [0, 4]


def test_server_spans_a_request_and_its_batch(stack):
    """A ``serve.queue`` span a request with its ``rid`` and its batch,
    whose dispatch, handoff and delivery spans carry that batch; the
    queue wait is part of the request's latency (one clock)."""
    var_cfg, vae_cfg, vp, qp = stack
    srv = GenerationServer(var_cfg, vae_cfg, vp, qp, SAMP, max_batch=4,
                           max_wait_ms=50.0, buckets=[2, 4], dtype=F32,
                           device="cpu")
    srv.start()
    try:
        with profiled():
            rids = [srv.submit(label=i % 10, seed=20 + i) for i in range(6)]
            results = {rid: srv.get(rid, timeout=300) for rid in rids}
    finally:
        srv.stop()
    assert all(r.ok for r in results.values())
    got = P.spans()
    queue = {s.ids["rid"]: s for s in named(got, "sdvar.serve.queue")}
    assert sorted(queue) == sorted(rids)
    batches = {name: {s.ids["batch"] for s in named(got, name)}
               for name in ("sdvar.serve.coalesce", "sdvar.serve.dispatch",
                            "sdvar.serve.handoff", "sdvar.serve.deliver")}
    dispatched = batches["sdvar.serve.dispatch"]
    assert all(b == dispatched for b in batches.values()), batches
    assert {s.ids["batch"] for s in queue.values()} == dispatched
    assert len(named(got, "sdvar.pixels")) == len(dispatched)
    for rid, s in queue.items():
        assert 0 <= s.host_ms <= 1e3 * results[rid].latency_s
    assert srv.stats["batches"] == len(dispatched)

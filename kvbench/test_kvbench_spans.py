"""The readers of the port's spans (``kvb.spans``) on made-up runs, the
device trace's idle gaps named by program span, its alignment to the
host's clock, and the harness's traced and untraced runs of a tiny cell
on the CPU (``run_cell``): the port's tracer in ``--trace 1`` runs
alone."""
from types import SimpleNamespace

import pytest

from kvb import spans
from kvb.tracing import MARKER

import tinybench

MS = 1_000_000      # ns


class Clock:
    """A stand-in for ``time`` whose ``perf_counter_ns`` reads ``t``."""

    def __init__(self):
        self.t = 0

    def perf_counter_ns(self):
        return self.t


def _record(tracer, clock, tree):
    from repro_torch.utils import timing
    name, t0, t1, kids = tree[:4]
    opts = tree[4] if len(tree) > 4 else {}
    clock.t = t0 * MS
    with timing.span(name, opts.get("rid")):
        for counter, value in opts.get("counts", {}).items():
            timing.count(counter, value)
        for kid in kids:
            _record(tracer, clock, kid)
        clock.t = t1 * MS


def _start(rid, t, select, to_host, encode, unpack, to_device, nbytes):
    """A cold start at ``t`` ms whose stages take the given ms."""
    kids, at = [], t
    for name, ms, inner in (
            ("prefill", 10, ()), ("extract", 1, ()), ("select", select, ()),
            ("compress", to_host + encode + 1,
             (("to_host", to_host, {"counts": {"to_host_bytes": nbytes}}),
              ("encode", encode, {}))),
            ("decompress", unpack + to_device + 1,
             (("unpack", unpack, {}),
              ("to_device", to_device,
               {"counts": {"to_device_bytes": nbytes // 2}}))),
            ("inject", 2, ())):
        sub, a = [], at
        for n, d, o in inner:
            sub.append((n, a, a + d, (), o))
            a += d
        kids.append((name, at, at + ms, sub))
        at += ms
    return ("start", t, at, kids, {"rid": rid})


def _iteration(t, prepare, launch, pull, commit, slots):
    kids, at = [], t
    for name, ms in (("prepare", prepare), ("launch", launch),
                     ("pull", pull), ("commit", commit)):
        kids.append((name, at, at + ms, ()))
        at += ms
    return ("decode_iteration", t, at + 1, kids,
            {"counts": {"decode_slots": slots}})


@pytest.fixture
def made_up(monkeypatch):
    """Two steps: starts of requests 1 and 2 and a decode iteration of 3
    slots, then a start of request 9 (not due in the window) and one of
    5 slots."""
    from repro_torch.utils import timing
    clock = Clock()
    monkeypatch.setattr(timing, "time", clock)
    tracer = timing.Tracer()
    timing.install(tracer)
    try:
        s1 = _start(1, 0, 2, 6, 19, 4, 9, 1_000_000)
        s2 = _start(2, s1[2], 4, 10, 30, 6, 11, 3_000_000)
        it = _iteration(s2[2], 20, 10, 15, 4, 3)
        _record(tracer, clock, ("step", 0, it[2] + 1, [s1, s2, it]))
        s9 = _start(9, 1000, 1, 1, 1, 1, 1, 5)
        it2 = _iteration(s9[2], 6, 4, 25, 1, 5)
        _record(tracer, clock, ("step", 1000, it2[2] + 1, [s9, it2]))
    finally:
        timing.uninstall()
    records = [SimpleNamespace(rid=r, breakdown={"compress": c,
                                                 "prefill": 0.01})
               for r, c in ((1, 0.026), (2, 0.041))]
    window = SimpleNamespace(due_in_window=lambda: records)
    probe = SimpleNamespace(spans={"decode_iteration": [0.05, 0.037]})
    return SimpleNamespace(window=window, probe=probe, spans=tracer)


def test_readers_by_hand(made_up):
    r = spans.READERS
    assert r["select_ms_p50"](made_up) == pytest.approx(3.0)
    assert r["codec_host_ms_p50"](made_up) == pytest.approx((25 + 40) / 2)
    assert r["codec_host_ms_p50.decode"](made_up) == pytest.approx(32.5)
    assert r["landing_host_ms_p50"](made_up) == pytest.approx((13 + 17) / 2)
    assert r["to_host_mb_per_start.decode"](made_up) == pytest.approx(2.0)
    assert r["to_device_mb_per_start"](made_up) == pytest.approx(1.0)
    assert r["decode_host_ms"](made_up) == pytest.approx((30 + 10) / 2)
    assert r["decode_pull_ms"](made_up) == pytest.approx((15 + 25) / 2)
    assert r["decode_live_slots"](made_up) == pytest.approx(4.0)
    ag = spans.agreement(made_up)
    assert ag["decode_iteration_ms"] == pytest.approx((50 + 37) / 2)
    assert ag["probe_decode_iter_ms"] == pytest.approx((50 + 37) / 2)
    assert ag["iteration_cover_min"] == pytest.approx(36 / 37)
    assert ag["compress_span_ms_p50"] == pytest.approx((26 + 41) / 2)
    assert ag["compress_breakdown_ms_p50"] == pytest.approx(33.5)
    assert ag["prefill_span_ms_p50"] == pytest.approx(10.0)
    table = spans.span_ms(made_up)
    assert table["start/compress/to_host"] == pytest.approx(8.0)
    assert table["start/compress/encode"] == pytest.approx(24.5)
    assert table["start/select"] == pytest.approx(3.0)
    assert table["decode_iteration/pull"] == pytest.approx(20.0)
    assert table["decode_iteration/commit"] == pytest.approx(2.5)


def test_readers_find_nothing_without_the_tracer(made_up):
    made_up.spans = None
    assert all(read(made_up) is None for read in spans.READERS.values())
    assert spans.agreement(made_up) == {} == spans.span_ms(made_up)


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 3.0, "args": {"correlation": corr}}


def _trace(launches: bool):
    """Host reads at 10 and 70 ms; the trace's clock 5,000 us ahead of
    the host's; each launch record 2 us after its read, each marker on
    the device 8 us after it; kernels busy 15-20 and 40-60 ms."""
    off = 5000.0
    ev = [_kernel(MARKER, 10_000 + off + 8, 1, 1),
          _kernel("void ns::gemm<128>(float*)", 15_000 + off, 5_000, 2),
          _kernel("split_scores", 40_000 + off, 20_000, 3),
          _kernel(MARKER, 70_000 + off + 8, 1, 4)]
    if launches:
        ev += [_launch(10_000 + off + 2, 1), _launch(70_000 + off + 2, 4)]
    marks = [(10 * MS, 10 * MS + 4_000), (70 * MS, 70 * MS + 4_000)]
    return ev, marks


def test_alignment_uses_launch_records_else_the_marker():
    ev, marks = _trace(True)
    al = spans.align(ev, marks)
    assert al["source"] == "launch"
    assert al["offset_us"] == pytest.approx(5002.0)
    assert al["error_us"] == pytest.approx([0.0, 0.0])
    assert al["bracket_us"] == pytest.approx([4.0, 4.0])
    ev, marks = _trace(False)
    al = spans.align(ev, marks)
    assert al["source"] == "marker"
    assert al["offset_us"] == pytest.approx(5008.0)


def test_idle_gaps_are_named_by_the_innermost_program_span(made_up):
    """Idle 10-15 ms and 20-40 ms, and 60-75 ms from the last kernel to
    the stop: each gap's start falls in one of the made-up spans (request
    1's extract and encode, request 2's prefill), named as a path below
    ``step``."""
    tracer = made_up.spans
    ev, marks = _trace(True)
    out, al = spans.summarize(ev, marks, 75 * MS, tracer,
                              [("decode_iteration", 0.0, 1.0)])
    assert al["unlabeled_s"] == pytest.approx(0.0)
    want = {}
    for t0, t1 in ((10, 15), (20, 40), (60, 75)):
        i = tracer.innermost_at(t0 * MS)
        path = tracer.path(i)
        want[path[len("step/"):]] = (t1 - t0) * 1e-3
    got = dict(out.idle_gaps())
    # the launch record lies 2 us after the host's read: the device's
    # times come out 2 us early
    assert got == pytest.approx(want, abs=3e-6)
    assert set(got) == {"start/extract", "start/compress/encode",
                        "start/prefill"}
    assert out.busy_s == pytest.approx(0.025)
    assert out.window_s == pytest.approx(0.065)
    # no program span open: the probe's label, counted as unlabeled
    late, _ = _trace(True)
    out, al = spans.summarize(late, marks, 75 * MS, None,
                              [("decode_iteration", 0.0, 1.0)])
    assert dict(out.idle_gaps()) == pytest.approx({"decode_iteration":
                                                   0.040}, abs=1e-5)
    assert al["unlabeled_s"] == pytest.approx(0.040, abs=1e-5)


class StubTrace:
    """``spans.ProgramTrace`` without the profiler: its two marks are
    host reads, and its trace is made up on a clock 5,000 us ahead of
    the host's, with each marker's launch record 2 us after its read and
    one kernel from the sub-window's start to the middle of the first
    ``step`` inside it (else over its first tenth), so that the idle gap
    after the kernel starts inside a program span."""

    def __init__(self, torch, tracer):
        self.tracer, self.marks, self.alignment = tracer, [], {}
        self.t_stop_ns = 0

    def start(self):
        import time
        t = time.perf_counter_ns()
        self.marks = [(t, t + 1_000)]

    def stop(self):
        import time
        t = time.perf_counter_ns()
        self.marks.append((t, t + 1_000))
        self.t_stop_ns = t + 2_000

    def summary(self, host_spans):
        off = 5000.0
        a, b = (m[0] / 1e3 for m in self.marks)
        mids = [(s.t0_ns + s.t1_ns) / 2e3 for s in self.tracer.spans
                if s.name == "step" and a < s.t0_ns / 1e3
                and 0 < s.t1_ns / 1e3 < b]
        end = mids[0] if mids else a + (b - a) / 10
        ev = [_kernel(MARKER, a + off + 8, 1, 1), _launch(a + off + 2, 1),
              _kernel("gemm", a + off + 20, end - a - 20, 2),
              _kernel(MARKER, b + off + 8, 1, 3), _launch(b + off + 2, 3)]
        out, self.alignment = spans.summarize(ev, self.marks, self.t_stop_ns,
                                              self.tracer, host_spans)
        return out


def _spy_on_the_window(monkeypatch):
    """What the tracer held when the window opened, and whether the probe
    was still installed when the tracer was removed."""
    from repro_torch.serving import workers
    from repro_torch.utils import timing
    from kvb.window import Window

    seen = {"uninstalled_with_probe": None}
    real_run, real_uninstall = Window.run, timing.uninstall
    real_iteration = workers.DecodeWorker.decode_iteration

    def run(w):
        seen["tracer"] = timing.installed()
        seen["at_open"] = (None if seen["tracer"] is None
                           else len(seen["tracer"].spans))
        return real_run(w)

    def uninstall():
        seen["uninstalled_with_probe"] = (
            workers.DecodeWorker.decode_iteration is not real_iteration)
        return real_uninstall()

    monkeypatch.setattr(Window, "run", run)
    monkeypatch.setattr(timing, "uninstall", uninstall)
    return seen


def _tiny(root, seed, seconds, trace):
    from kvb.harness import run_cell
    return run_cell("tiny.pd", seed, seconds, trace, "cpu", 0.0,
                    root / "BENCHMARK.json", root, log=lambda s: None)


def test_traced_run_installs_clears_and_removes_the_tracer(
        tmp_path, monkeypatch):
    """``--trace 1``: the port's tracer is installed before set-up (the
    warm-up's spans are in it), cleared when the window opens and
    removed once the probe is; ``--trace 0`` installs none."""
    from repro_torch.utils import timing
    from repro_torch.serving import workers

    monkeypatch.setattr(spans, "ProgramTrace", StubTrace)
    real_iteration = workers.DecodeWorker.decode_iteration
    root = tinybench.build(tmp_path)
    seen = _spy_on_the_window(monkeypatch)
    res = _tiny(root, 20260418, 1.5, True)
    assert seen["at_open"] == 0         # cleared when the window opened
    names = {s.name for s in seen["tracer"].spans}
    assert {"step", "start", "decode_iteration"} <= names
    assert seen["uninstalled_with_probe"] is False
    assert timing.installed() is None
    assert workers.DecodeWorker.decode_iteration is real_iteration
    assert res["correct"] and "program_spans" in res
    seen = _spy_on_the_window(monkeypatch)
    res = _tiny(root, 20260419, 1.5, False)
    assert seen["tracer"] is None and seen["uninstalled_with_probe"] is None
    assert res["correct"] and "program_spans" not in res


def test_traced_run_reads_the_spans_in_a_traced_run(tmp_path, monkeypatch):
    """``--trace 1`` through the harness on the CPU, the profiler stubbed:
    the result carries every reader's value, the eight span metrics among
    the per-layer metrics, the agreement, the alignment, and idle gaps
    named by program span."""
    from repro_torch.utils import timing

    monkeypatch.setattr(spans, "ProgramTrace", StubTrace)
    root = tinybench.build(tmp_path)
    res = _tiny(root, 3000000019, 1.5, True)
    assert timing.installed() is None
    assert set(res["program_spans"]) == set(spans.READERS)
    for name in ("select_ms_p50", "codec_host_ms_p50",
                 "landing_host_ms_p50", "to_host_mb_per_start.decode",
                 "to_device_mb_per_start", "decode_host_ms",
                 "decode_pull_ms", "decode_live_slots"):
        assert res["program_spans"][name] > 0, name
    for name in set(spans.READERS) - {"to_device_mb_per_start"}:
        assert res["metrics"][name]["value"] == res["program_spans"][name]
    assert res["agreement"]["decode_iteration_ms"] > 0
    assert res["agreement"]["iteration_cover_min"] > 0
    assert res["alignment"]["source"] == "launch"
    assert res["alignment"]["error_us"] == pytest.approx([0.0, 0.0])
    assert "start/compress" in res["span_ms"]
    # idle before the first kernel starts between steps, where the
    # sub-window opens: the probe's label, counted as unlabeled
    gaps = dict(res["breakdown"]["idle_gaps"])
    named = {g: t for g, t in gaps.items()
             if g.split("/")[0] in ("start", "decode_iteration", "step")}
    assert sum(named.values()) >= 0.95 * sum(gaps.values())
    assert res["alignment"]["unlabeled_s"] == pytest.approx(
        sum(gaps.values()) - sum(named.values()))
    assert res["pace"]["steps"] > 0 and res["correct"]
    assert list(res)[-1] == "checks"


def test_a_traced_run_whose_program_records_no_span_reports_no_span_metric(
        tmp_path, monkeypatch):
    """Where the port's tracer never reaches the program (here: installing
    it does nothing), the span readers find nothing, and the harness
    leaves their metrics out of the line rather than reading 0."""
    from repro_torch.utils import timing

    monkeypatch.setattr(spans, "ProgramTrace", StubTrace)
    monkeypatch.setattr(timing, "install", lambda tracer: None)
    root = tinybench.build(tmp_path)
    res = _tiny(root, 1, 1.0, True)
    assert all(v is None for v in res["program_spans"].values())
    assert not set(spans.READERS) & set(res["metrics"])
    assert "decode_iter_ms" in res["metrics"]
    assert timing.installed() is None

"""The serving path's tracer (``repro_torch.utils.timing``) on tiny-lm.

Off, every site hands back the one shared no-op, reads no clock and
allocates nothing.  On, a PD ``ServingRuntime`` records each cold start
as ``start`` with its six children carrying its request id, each decode
iteration as four children that tile it, and the bytes each start
copies to the host and lands back on the device; and it serves the same
tokens as a run with the tracer off.  Seeded random weights: no cached model is needed."""
import itertools
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.utils import timing  # noqa: E402
from repro_torch.utils.timing import NO_SPAN, Tracer  # noqa: E402

SEQ, OUT, REQUESTS = 32, 6, 3
START_CHILDREN = ("prefill", "extract", "select", "compress", "decompress",
                  "inject")
STEP_CHILDREN = ("prepare", "launch", "pull", "commit")
SITES = ("step", "start", *START_CHILDREN, "to_host", "encode", "unpack",
         "to_device", "decode_iteration", *STEP_CHILDREN)


@pytest.fixture(scope="module")
def tiny():
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config("tiny-lm")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _profile(kind: str):
    from repro_torch.core.profiles import IDENTITY_PROFILE, Profile
    from repro_torch.core.strategy import StrategyConfig
    if kind == "identity":
        return IDENTITY_PROFILE
    return Profile(StrategyConfig(
        quantizer="uniform", key_bits=8, value_bits=8,
        granularity="per_token", symmetric=True, group_size=32),
        cr=2.0, s_enc=5e8, s_dec=5e8)


def _serve(tiny, kind: str, tracer=None):
    """REQUESTS cold requests through a one-card PD runtime on the wall
    clock (so every codec stage runs), with ``tracer`` installed."""
    from repro_torch.serving import GBPS, BandwidthTrace, SchedulerConfig
    from repro_torch.serving.engine import RuntimeConfig, ServingRuntime
    rt = ServingRuntime(
        static_profile=_profile(kind),
        config=RuntimeConfig(seq=SEQ, decode_tokens=OUT, mode="pd",
                             paged=True, page_size=8,
                             pd_inject_restored=True),
        trace=BandwidthTrace.constant(GBPS),
        scheduler=SchedulerConfig(max_slots=4, max_prefills_per_step=2),
        device="cpu")
    rt.model_cfg, rt.params = tiny
    for i in range(REQUESTS):
        rt.submit("qalike", prompt_seed=i, out_tokens=OUT)
    if tracer is not None:
        timing.install(tracer)
    try:
        rt.run()
    finally:
        timing.uninstall()
    return rt


def _children(tracer, i):
    return [j for j, s in enumerate(tracer.spans) if s.parent == i]


def _inside(a, b) -> bool:
    return b.t0_ns <= a.t0_ns <= a.t1_ns <= b.t1_ns


def test_off_every_site_is_the_shared_no_op_and_reads_no_clock(
        tiny, monkeypatch):
    assert timing.installed() is None
    assert all(timing.span(n) is NO_SPAN for n in SITES)
    assert timing.span("start", 7) is NO_SPAN

    class NoClock:
        @staticmethod
        def perf_counter_ns():
            raise AssertionError("a site read the clock with tracing off")

    monkeypatch.setattr(timing, "time", NoClock)
    rt = _serve(tiny, "int8")
    assert len(rt.completed) == REQUESTS


def test_off_sites_allocate_nothing():
    """With no tracer the site calls allocate nothing (the loop's own
    iterator is the only allocation, as in an empty loop)."""
    x, t = np.zeros(8), torch.zeros(8)

    def empty(n):
        for _ in itertools.repeat(None, n):
            pass

    def sites(n):
        span, count, count_bytes = (timing.span, timing.count,
                                    timing.count_bytes)
        for _ in itertools.repeat(None, n):
            span("start", 7)
            count("decode_slots", 4)
            count_bytes("to_host_bytes", t, x)

    def peak(fn):
        """Least (peak, net) growth over three runs, once warm (the
        interpreter specialises a loop's code on its first runs)."""
        fn(100)
        out = []
        for _ in range(3):
            c0, _ = tracemalloc.get_traced_memory()
            tracemalloc.reset_peak()
            fn(1000)
            c1, p = tracemalloc.get_traced_memory()
            out.append((p - c0, c1 - c0))
        return min(out)

    tracemalloc.start()
    try:
        assert peak(sites) == peak(empty)
    finally:
        tracemalloc.stop()


def test_tracer_paths_and_innermost_span():
    tr = Tracer()
    timing.install(tr)
    try:
        with timing.span("step"):
            with timing.span("start", 3):
                with timing.span("compress"):
                    timing.count("to_host_bytes", 10)
            with timing.span("decode_iteration"):
                pass
    finally:
        timing.uninstall()
    names = [s.name for s in tr.spans]
    assert names == ["step", "start", "compress", "decode_iteration"]
    assert [s.rid for s in tr.spans] == [None, 3, 3, None]
    assert tr.path(2) == "step/start/compress"
    assert [(c.name, c.rid, c.value) for c in tr.counts] == [
        ("to_host_bytes", 3, 10)]
    step, start, comp, dec = tr.spans
    assert tr.innermost_at(comp.t0_ns) == 2
    assert tr.innermost_at(dec.t1_ns) == 3
    assert tr.innermost_at(step.t0_ns - 1) == -1
    assert tr.innermost_at(step.t1_ns + 1) == -1
    with pytest.raises(RuntimeError):
        timing.install(tr)
        timing.install(Tracer())
    timing.uninstall()
    tr.clear()
    assert not tr.spans and not tr.counts


def test_cold_starts_carry_their_spans_and_rids(tiny):
    tr = Tracer()
    rt = _serve(tiny, "int8", tr)
    starts = [i for i, s in enumerate(tr.spans) if s.name == "start"]
    assert sorted(tr.spans[i].rid for i in starts) == sorted(
        r.rid for r in rt.completed)
    for i in starts:
        s = tr.spans[i]
        assert tr.spans[s.parent].name == "step"
        kids = _children(tr, i)
        assert [tr.spans[j].name for j in kids] == list(START_CHILDREN)
        for j in kids:
            assert tr.spans[j].rid == s.rid and _inside(tr.spans[j], s)
        comp, dec = kids[3], kids[4]
        assert {tr.spans[j].name for j in _children(tr, comp)} == {
            "to_host", "encode"}
        assert {tr.spans[j].name for j in _children(tr, dec)} == {
            "unpack", "to_device"}
    for i, s in enumerate(tr.spans):
        assert s.t1_ns >= s.t0_ns
        if s.parent >= 0:
            assert _inside(s, tr.spans[s.parent])
    # int8 codes (one byte a value) and f16 scales (one per 32 values),
    # to the host and back to the device
    m = tiny[0]
    n = m.num_layers * m.kv_heads * SEQ * m.resolved_head_dim
    for rid in {tr.spans[i].rid for i in starts}:
        for name in ("to_host_bytes", "to_device_bytes"):
            got = sum(c.value for c in tr.counts
                      if c.name == name and c.rid == rid)
            assert got == 2 * (n + n // 32 * 2), name


def test_decode_iteration_children_tile_it(tiny):
    tr = Tracer()
    rt = _serve(tiny, "int8", tr)
    iters = [i for i, s in enumerate(tr.spans)
             if s.name == "decode_iteration"]
    assert iters
    slots = [c for c in tr.counts if c.name == "decode_slots"]
    assert len(slots) == len(iters)
    assert sum(c.value for c in slots) == sum(
        len(r.tokens) - 1 for r in rt.completed)
    for i in iters:
        parent = tr.spans[i]
        kids = [tr.spans[j] for j in _children(tr, i)]
        assert [k.name for k in kids] == list(STEP_CHILDREN)
        assert all(a.t1_ns <= b.t0_ns for a, b in zip(kids, kids[1:]))
        covered = sum(k.t1_ns - k.t0_ns for k in kids)
        assert 0 <= (parent.t1_ns - parent.t0_ns) - covered


def test_identity_copies_its_kv_once_each_way_in_fp16(tiny):
    tr = Tracer()
    _serve(tiny, "identity", tr)
    m = tiny[0]
    n = m.num_layers * m.kv_heads * SEQ * m.resolved_head_dim
    rids = {s.rid for s in tr.spans if s.name == "start"}
    assert len(rids) == REQUESTS
    for rid in rids:
        for name in ("to_host_bytes", "to_device_bytes"):
            got = [c.value for c in tr.counts
                   if c.name == name and c.rid == rid]
            assert got == [2 * n * 2], name
    paths = {tr.path(i) for i, s in enumerate(tr.spans)
             if s.name in ("to_host", "encode", "unpack", "to_device")}
    assert paths == {"step/start/compress/to_host",
                     "step/start/compress/encode",
                     "step/start/decompress/unpack",
                     "step/start/decompress/to_device"}


@pytest.mark.parametrize("kind", ["int8", "identity"])
def test_tracing_serves_the_same_tokens(tiny, kind):
    off = _serve(tiny, kind)
    on = _serve(tiny, kind, Tracer())
    assert [(r.rid, r.tokens.tolist()) for r in off.completed] == [
        (r.rid, r.tokens.tolist()) for r in on.completed]

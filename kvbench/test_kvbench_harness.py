"""The harness on the CPU: discovery by name, the window's clocks and
censoring, the throughput, the yardstick's counts, the import check and
the registry check."""
import json
import sys

import numpy as np
import pytest

from kvb import counts, spec
from kvb.harness import end_to_end, forbidden_modules
from kvb.traffic import Req, Traffic
from kvb.window import Record, Window, quantile

import tinybench


@pytest.fixture
def root(tmp_path):
    return tinybench.build(tmp_path)


def test_cell_traffic_and_metric_are_found_by_name(root):
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "metrics" / "zz_added.py").write_text(
        "def read(run):\n    return 7.0\n")
    (root / "cells" / "tiny.more.json").write_text(
        (root / "cells" / "tiny.pd.json").read_text())
    (root / "traffic" / "more.json").write_text(
        (root / "traffic" / "tiny.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.more", "config": "tiny",
                               "traffic": "more", "chips": 1})
    bench["per_layer"].append({"name": "zz_added", "unit": "x",
                               "workloads": ["tiny.more"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("tiny.more", root / "BENCHMARK.json", root)
    assert cell.traffic["prompt_tokens"] == 64
    assert "zz_added" in [m["name"] for m in cell.per_layer]
    assert spec.metric_reader(root, "zz_added")(None) == 7.0
    old = spec.load_cell("tiny.pd", root / "BENCHMARK.json", root)
    assert "zz_added" not in [m["name"] for m in old.per_layer]
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, f"{p} was edited"


def _window(c0=100.0, c_end=110.0):
    w = Window(rt=None, traffic=None, seconds=0.0, q_min=0.97)
    w.c0, w.c_end = c0, c_end
    return w


def _rec(rid, due, **kw):
    return Record(rid=rid, req=Req(rid, due, "qalike", rid, 4), due=due,
                  **kw)


def test_ttft_is_timed_from_due_and_censored_at_the_close():
    w = _window()
    # submitted 0.5 s after due, 1.0 s to the first token on the runtime
    # clock: 1.5 s from due; the runtime never saw the wait before submit
    w.records = {
        1: _rec(1, 101.0, submitted=101.5, ttft=1.5, jct=4.0, tokens=5),
        2: _rec(2, 104.0, submitted=104.0, ttft=2.0, tokens=3,
                censored=True),
        3: _rec(3, 108.0, submitted=108.2, censored=True),   # no first token
        4: _rec(4, 112.0, censored=True),                    # due after close
    }
    assert sorted(w.ttfts()) == [1.5, 2.0, pytest.approx(2.0)]
    assert sorted(w.jcts()) == [pytest.approx(2.0), 4.0, 6.0]
    assert w.tpots() == [pytest.approx((4.0 - 1.5) / 4)]


def test_close_adds_lag_and_unsubmitted_requests(monkeypatch):
    class Slot:
        ttft, toks, breakdown, profile = 0.25, [1, 2], {"queue": 0.1}, "p"
        wire_bytes = 10

    class Done:
        rid, ttft, jct, tokens = 1, 0.5, 3.0, np.arange(4)
        breakdown, profile, wire_bytes = {}, "p", 10

    class RT:
        completed = [Done()]
        _slots = {2: Slot()}

    traffic = Traffic({"arrivals": "stratified", "workloads": ["qalike"],
                       "out_tokens": {"dist": "lognormal", "median": 4,
                                      "sigma": 0.5, "min": 1, "max": 8}},
                      {"rate_per_s": 1.0}, seed=3)
    w = _window(c0=0.0, c_end=traffic.due(3) + 1e-9)
    w.rt, w.traffic, w.next_index = RT(), traffic, 2
    w.records = {1: _rec(1, traffic.due(0), submitted=traffic.due(0) + 0.1),
                 2: _rec(2, traffic.due(1), submitted=traffic.due(1) + 0.2)}
    w._close()
    assert w.records[1].ttft == pytest.approx(0.6)
    assert w.records[1].jct == pytest.approx(3.1)
    assert w.records[2].ttft == pytest.approx(0.45) and w.records[2].censored
    # arrivals 2 and 3 were due before the close but never submitted
    assert {-3, -4} <= set(w.records)
    assert len(w.due_in_window()) == 4


def test_out_tok_per_s_is_tokens_over_window_wall(root):
    cell = spec.load_cell("tiny.pd", root / "BENCHMARK.json", root)
    w = _window()
    w.tokens, w.wall = 300, 2.5
    w.records = {}
    m = end_to_end(cell, w, setup_s=1.0)
    assert m["out_tok_per_s"]["value"] == pytest.approx(120.0)
    assert m["setup_s"]["value"] == 1.0
    assert "ttft_p50_ms" not in m


def test_quantile_is_inclusive_linear():
    vals = list(range(1, 11))
    assert quantile(vals, 0.9) == pytest.approx(9.1)
    assert quantile(vals, 0.5) == pytest.approx(5.5)


def test_traffic_gives_every_seed_the_same_schedule_and_its_own_prompts():
    tr = {"arrivals": "stratified", "workloads": ["qalike", "codelike",
                                               "mathlike"],
          "out_tokens": {"dist": "lognormal", "median": 32, "sigma": 0.8,
                         "min": 8, "max": 128}}
    a = Traffic(tr, {"rate_per_s": 2.0}, seed=1)
    b = Traffic(tr, {"rate_per_s": 2.0}, seed=(1 << 31) + 12345)
    ra = [a.request(i) for i in range(48)]
    rb = [b.request(i) for i in range(48)]
    assert [(r.due, r.out_tokens, r.workload) for r in ra] == \
        [(r.due, r.out_tokens, r.workload) for r in rb]
    # each block of 16 holds the distribution's 16 quantiles, in an order
    # that is not sorted
    block = [r.out_tokens for r in ra[16:32]]
    assert sorted(block) == sorted(r.out_tokens for r in ra[:16])
    assert block != sorted(block)
    gaps = np.diff([0.0] + [r.due for r in ra[:16]])
    u = (np.arange(16) + 0.5) / 16
    assert np.allclose(sorted(gaps), sorted(-np.log1p(-u) / 2.0))
    assert sorted(r.workload for r in ra[:3]) == ["codelike", "mathlike",
                                                  "qalike"]
    assert len({r.prompt_seed for r in ra + rb}) == 96
    assert [a.request(i) for i in range(5)] == ra[:5]


def test_counts_by_hand():
    """The yardstick's sums over the shipped configurations' module's
    counts (``reference/decoder.py::sizes``)."""
    def sizes(name):
        cfg = json.loads((spec.BENCH_DIR / "configs" / f"{name}.json")
                         .read_text())
        return spec.load_model(spec.BENCH_DIR, cfg).sizes(cfg)

    qwen = sizes("qwen3-4b")
    attn = 2560 * 32 * 128 * 2 + 2 * 2560 * 8 * 128
    per_layer = attn + 3 * 2560 * 9728
    assert qwen["weights_per_token"] == \
        36 * per_layer + 2560 * 151936 == 4_022_272_000
    ds = sizes("deepseek-moe-16b")
    attn = 4 * 2048 * 16 * 128
    moe = 2048 * 64 + 6 * 3 * 2048 * 1408 + 3 * 2048 * 1408 * 2
    assert ds["weights_per_token"] == (
        28 * attn + 3 * 2048 * 1408 + 27 * moe + 2048 * 102400)
    # two slots at contexts 10 and 20: weights twice, QK + PV over 30
    p = qwen["weights_per_token"]
    assert counts.decode_step_flops(qwen, [10, 20]) == \
        2 * (2 * p) + 4 * 32 * 128 * 36 * 30
    assert counts.prefill_flops(qwen, 3) == \
        2 * ((p - 2560 * 151936) * 3 + 2560 * 151936) \
        + 4 * 32 * 128 * 36 * 6
    assert counts.quant_pack_bytes(2, 128, 8, 64, 2) == 2 * 128 * 3 + 16
    assert counts.quant_pack_bytes(2, 128, 4, 32, 4) == 2 * 128 * 4.5 + 32
    from reference import decoder
    tiny = decoder.sizes({"kv_heads": 2, "head_dim": 4, "num_heads": 4,
                          "num_layers": 3, "d_model": 8, "d_ff": 8,
                          "vocab_size": 16})
    # one slot: 6 positions, 2 of them quant-resident; 2 slots in the arena
    per_layer = (2 * 2 * 4 * (5 * 2 + 2 * 4) + 2 * 2 * 4 * 16 * 2
                 + 2 * 4 * 4 * 2 * 2 + 2 * 4 * 4 * 2 + 2 * (5 + 2) * 4)
    assert counts.paged_attention_bytes(tiny, [6], [2], 2, 5, 16) == \
        3 * per_layer


def test_import_check_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake.sub", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert forbidden_modules() == ["repro"]
    monkeypatch.setitem(sys.modules, "jax", object())
    assert forbidden_modules() == ["jax", "repro"]


def test_a_width_that_disagrees_with_the_registry_fails_the_run(tmp_path):
    from kvb.harness import run_cell
    root = tinybench.build(tmp_path, d_model=96)
    with pytest.raises(ValueError, match="d_model"):
        run_cell("tiny.pd", 1, 0.5, False, "cpu", 0.0,
                 root / "BENCHMARK.json", root)


@pytest.mark.parametrize("key,value", [("sliding_window", 4096),
                                       ("d_model", 96)])
def test_a_key_that_disagrees_with_the_registry_fails(key, value):
    """Every key of the file that names a field of the port's
    ``ModelConfig`` is held, those outside the widths and equations the
    reference reads too."""
    cfg = json.loads((spec.BENCH_DIR / "configs" / "deepseek-moe-16b.json")
                     .read_text())
    spec.check_registry(dict(cfg, sliding_window=0))
    with pytest.raises(ValueError, match=key):
        spec.check_registry(dict(cfg, **{key: value}))


def test_shipped_configurations_match_the_registry():
    for name in ("deepseek-moe-16b", "qwen3-4b"):
        spec.check_registry(json.loads(
            (spec.BENCH_DIR / "configs" / f"{name}.json").read_text()))


def test_benchmark_json_names_files_that_exist():
    bench = json.loads((spec.BENCH_DIR.parent / "BENCHMARK.json")
                       .read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], spec.BENCH_DIR.parent
                              / "BENCHMARK.json")
        assert spec.profile_path(cell.root, cell.cell["profiles"]).is_file()
    for m in bench["per_layer"]:
        spec.metric_reader(spec.BENCH_DIR, m["name"])

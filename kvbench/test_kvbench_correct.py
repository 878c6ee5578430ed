"""``correct`` on the CPU at a tiny size: a sound run passes; the control
(the reference in fp8 in the program's place) and each fault the PD cells
can have, planted under the timed path, come out not correct."""
import pytest
import torch

import tinybench
from kvb.harness import run_cell

SECONDS = 2.0


def _run(root, **kw):
    return run_cell("tiny.pd", 20260418, SECONDS, False, "cpu", 0.0,
                    root / "BENCHMARK.json", root, **kw)


@pytest.fixture
def root(tmp_path):
    return tinybench.build(tmp_path)


def test_a_sound_run_is_correct_and_reports_its_metrics(root):
    res = _run(root)
    assert res["correct"], (res["checks"], res["readings"])
    assert set(res["metrics"]) == {"ttft_p50_ms", "jct_p50_ms",
                                   "tpot_p50_ms", "setup_s",
                                   "out_tok_per_s"}
    assert res["attempted"] > 0 and res["readings"]["sampled"] >= 2
    assert res["checks"]["landed_mismatch"]["value"] == 0
    assert list(res)[-1] == "checks"


def test_a_closed_loop_run_is_correct(tmp_path):
    root = tinybench.build(tmp_path, closed=True)
    res = _run(root)
    assert res["correct"], res["checks"]
    assert res["metrics"]["out_tok_per_s"]["value"] > 0


def test_the_control_fails_the_limits(root):
    """The harness's own verdict, under the cell's limits, finds the
    control not correct, where it finds the program correct."""
    res = _run(root, lowp=True)
    r = res["readings"]
    assert res["correct"], res["checks"]
    assert res["control"]["correct"] is False, res["control"]
    assert set(res["control"]["checks"]) == set(tinybench.LIMITS)
    assert (r["control_gap_mean"] > tinybench.LIMITS["gap_mean"]
            or r["control_kv_rel_err"] > tinybench.LIMITS["kv_rel_err"]), r
    assert list(res)[-1] == "checks"


def test_a_landing_altered_in_the_arena_fails(root, monkeypatch):
    """The restored KV lands in the arena 2% off what the wire carried:
    the landed first layer no longer matches the payload."""
    from repro_torch.serving import workers
    real = workers.inject_kv_paged

    def altered(cfg, pool, row, kv, page_size):
        kv.k = kv.k * 1.02
        return real(cfg, pool, row, kv, page_size)

    monkeypatch.setattr(workers, "inject_kv_paged", altered)
    res = _run(root)
    assert not res["correct"]
    assert res["checks"]["landed_mismatch"]["value"] > 0


def test_a_token_altered_where_it_is_produced_fails(root, monkeypatch):
    from repro_torch.serving import workers
    real = workers._paged_steps

    def altered(name, page_size):
        arena, copy = real(name, page_size)

        def step(*args):
            nxt, pool = arena(*args)
            return torch.where(nxt > 0, (nxt + 1) % 512, nxt), pool
        return step, copy

    monkeypatch.setattr(workers, "_paged_steps", altered)
    res = _run(root)
    assert not res["correct"]
    assert res["checks"]["gap_mean"]["value"] > \
        tinybench.LIMITS["gap_mean"]


def test_a_step_that_returns_its_state_unchanged_fails(root, monkeypatch):
    """Each decode iteration emits its tokens but hands the next one the
    state it was given: the slots' positions and last tokens."""
    from repro_torch.serving import workers
    real = workers.DecodeWorker.decode_iteration

    def stuck(self, active):
        pos, last = self._positions.copy(), self._last_tok.copy()
        out = real(self, active)
        self._positions[:] = pos
        self._last_tok[:] = last
        return out

    monkeypatch.setattr(workers.DecodeWorker, "decode_iteration", stuck)
    res = _run(root)
    assert not res["correct"]
    assert res["checks"]["gap_mean"]["value"] > \
        tinybench.LIMITS["gap_mean"]


def test_a_payload_altered_on_the_wire_fails(root, monkeypatch):
    from repro_torch.core import pipeline
    real = pipeline._device_quantize

    def altered(x, bits, group, codec):
        w = real(x, bits, group, codec)
        w.scale = w.scale * 1.25
        return w

    monkeypatch.setattr(pipeline, "_device_quantize", altered)
    res = _run(root)
    assert not res["correct"]
    assert res["checks"]["kv_rel_err"]["value"] > \
        tinybench.LIMITS["kv_rel_err"]


def test_bytes_billed_other_than_sent_fail(root, monkeypatch):
    from repro_torch.serving import network
    real = network.KVWire.send

    def padded(self, ready, nbytes):
        return real(self, ready, nbytes + 4096)

    monkeypatch.setattr(network.KVWire, "send", padded)
    res = _run(root)
    assert not res["correct"]
    assert res["checks"]["wire_mismatch"]["value"] > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a cell runs at full width")
    return torch.device("cuda")


@pytest.mark.gpu
def test_the_first_cell_runs_correct_on_the_card(card):
    import time
    from kvb import spec
    res = run_cell("dsmoe16b.pd_cold.2gbps", 1234567, 10.0, False, "cuda",
                   time.perf_counter(),
                   spec.BENCH_DIR.parent / "BENCHMARK.json")
    assert res["correct"], res["checks"]

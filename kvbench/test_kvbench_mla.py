"""The DeepSeek-V2-Lite configuration's module (``reference/mla.py``) on
the CPU at a tiny size: its payload decoding, byte count and landed parts
against the port's, a whole PD cell of the reduced MLA model through the
harness (sound, then with the rope key altered where it lands), and the
configuration file against the registry."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from kvb import spec
from kvb.harness import run_cell

HERE = Path(__file__).resolve().parent
ARCH = "deepseek-v2-lite-reduced"
SEQ = 64
LIMITS = {"gap_mean": 0.05, "kv_rel_err": 0.05}


def published(c) -> dict:
    """The published config's keys for a port ``ModelConfig`` of MLA."""
    return {
        "num_hidden_layers": c.num_layers, "hidden_size": c.d_model,
        "num_attention_heads": c.num_heads, "kv_lora_rank": c.kv_lora_rank,
        "q_lora_rank": None, "qk_nope_head_dim": c.qk_nope_head_dim,
        "qk_rope_head_dim": c.qk_rope_head_dim, "v_head_dim": c.v_head_dim,
        "intermediate_size": c.dense_d_ff, "moe_intermediate_size": c.d_ff,
        "n_routed_experts": c.num_experts,
        "num_experts_per_tok": c.experts_per_token,
        "n_shared_experts": c.num_shared_experts,
        "first_k_dense_replace": c.moe_dense_prefix,
        "norm_topk_prob": c.norm_topk_prob, "routed_scaling_factor": 1,
        "rope_theta": c.rope_theta, "rms_norm_eps": c.rmsnorm_eps,
        "vocab_size": c.vocab_size,
        "rope_scaling": {
            "beta_fast": c.yarn_beta_fast, "beta_slow": c.yarn_beta_slow,
            "factor": c.yarn_factor, "mscale": c.yarn_mscale,
            "mscale_all_dim": c.yarn_mscale_all_dim,
            "original_max_position_embeddings":
                c.yarn_original_max_position, "type": "yarn"}}


def build(root: Path) -> Path:
    """A benchmark root of one PD cell of the reduced MLA model: 64-token
    prompts, an int8 profile whose group tiles both parts (8) and an int4
    one whose group (16) is wider than the 8-wide rope key."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.core.profiles import Profile
    from repro_torch.core.strategy import StrategyConfig

    for d in ("configs", "cells", "traffic", "profiles"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "reference"):
        shutil.copytree(HERE / d, root / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    c = get_config(ARCH)
    cfg = dict(published(c), name="tiny-mla", source="test", registry=ARCH,
               reference="reference/mla.py", num_layers=c.num_layers,
               d_model=c.d_model, kv_lora_rank=c.kv_lora_rank,
               capacity_factor=c.capacity_factor)
    (root / "configs/tiny-mla.json").write_text(json.dumps(cfg))
    traffic = {"arrivals": "stratified", "prompt_tokens": SEQ,
               "workloads": ["qalike", "codelike", "mathlike"],
               "out_tokens": {"dist": "lognormal", "median": 8,
                              "sigma": 0.5, "min": 4, "max": 16}}
    (root / "traffic/tiny.json").write_text(json.dumps(traffic))
    cell = {"mode": "pd", "paged": True, "page_size": 16,
            "pd_inject_restored": True, "store_capacity": 1 << 26,
            "q_min": 0.97, "sample": 4, "slots": 4,
            "bandwidth_gbps": 0.001, "rate_per_s": 20.0,
            "max_prefills_per_step": 1, "profiles": "tiny-mla",
            "limits": LIMITS, "slo_metric": "ttft"}
    (root / "cells/tiny-mla.pd.json").write_text(json.dumps(cell))
    profs = [Profile(StrategyConfig(
        quantizer="uniform", key_bits=b, value_bits=b,
        granularity="per_token", symmetric=True, group_size=g),
        cr=cr, s_enc=5e8, s_dec=5e8,
        quality={"qalike": 0.99, "codelike": 0.99, "mathlike": 0.99})
        for b, g, cr in ((8, 8, 1.9), (4, 16, 3.6))]
    (root / "profiles/tiny-mla.jsonl").write_text(
        "".join(p.to_json() + "\n" for p in profs))
    e2e = [{"name": n, "unit": u} for n, u in (
        ("ttft_p50_ms", "ms"), ("jct_p50_ms", "ms"), ("setup_s", "s"))]
    layers = [{"name": n, "unit": "x"} for n in (
        "wire_mb_per_cold", "extracted_kb_per_token",
        "mla_attention_roofline")]
    bench = {"workloads": [{"name": "tiny-mla.pd", "config": "tiny-mla",
                            "traffic": "tiny", "chips": 1}],
             "end_to_end": e2e, "per_layer": layers}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build(tmp_path_factory.mktemp("mla"))


def _run(root, trace=False):
    return run_cell("tiny-mla.pd", 20260418, 1.0, trace, "cpu", 0.0,
                    root / "BENCHMARK.json", root, log=lambda s: None)


@pytest.mark.parametrize("bits,group", [(16, 16), (8, 8), (4, 16)])
def test_payload_parts_and_bytes_are_the_ports(root, bits, group):
    """The module decodes and counts a payload of the port's pipeline as
    the port does, part by part at each part's width (the identity, a
    group that tiles both parts, a group wider than the rope key), and
    reads a slot's landed parts out of the port's paged arena."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import CompressionPipeline
    from repro_torch.core.quality import extract_kv
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.models.transformer import prefill
    from repro_torch.serving.workers import DecodeWorker, ModelHandle, \
        RuntimeConfig
    from kvb.weights import make_params
    from reference import mla, prompts

    cfg = get_config(ARCH)
    params = make_params(cfg, 3, "cpu", mla.init_scale)
    ids = prompts.prompt_ids("codelike", 3, SEQ)
    with torch.no_grad():
        _, caches = prefill(cfg, params, {"tokens": torch.as_tensor(
            ids[None], dtype=torch.int32)}, SEQ)
    kv = extract_kv(cfg, caches, 0, SEQ)
    assert kv.k.shape == (cfg.num_layers, 1, SEQ, cfg.kv_lora_rank)
    assert kv.v.shape == (cfg.num_layers, 1, SEQ, cfg.qk_rope_head_dim)
    pipe = CompressionPipeline(StrategyConfig(
        quantizer="uniform", key_bits=bits, value_bits=bits,
        granularity="per_token", symmetric=True, group_size=group),
        device="cpu")
    comp = pipe.compress(kv)
    back = pipe.decompress(comp)
    parts = mla.payload_parts(comp, "cpu")
    for got, want in zip(parts, (back.k, back.v)):
        assert torch.equal(got, torch.as_tensor(np.asarray(want)).float())
    assert mla.payload_bytes(comp) == comp.total_bytes()
    dw = DecodeWorker(0, ModelHandle(cfg, params, "cpu"),
                      RuntimeConfig(seq=SEQ, decode_tokens=8, paged=True),
                      n_slots=2, store=None)
    dw.inject_restored(back, 1)
    landed = mla.landed_parts(dw, 1, SEQ)
    for got, want in zip(landed, parts):
        assert torch.equal(got.float(), want[0].to(torch.bfloat16).float())


def test_a_sound_mla_run_is_correct(root, monkeypatch):
    """A whole PD run of the reduced MLA model, traced (the profiler
    stubbed): correct, each part landed as sent, and the extracted cache
    the latent and the rope key a token, not per-head K and V."""
    from test_kvbench_spans import StubTrace
    from kvb import spans

    monkeypatch.setattr(spans, "ProgramTrace", StubTrace)
    res = _run(root, trace=True)
    assert res["correct"], res["checks"]
    assert res["checks"]["landed_mismatch"]["value"] == 0
    assert res["readings"]["sampled"] > 0
    from repro_torch.configs import get_config
    c = get_config(ARCH)
    want = c.num_layers * (c.kv_lora_rank + c.qk_rope_head_dim) * 2 / 1e3
    assert res["metrics"]["extracted_kb_per_token"]["value"] \
        == pytest.approx(want)


def test_a_rope_key_landed_2pct_off_fails(root, monkeypatch):
    """The rope key alone, 2% off where the decode worker lands it: the
    landing check compares each part, so the run is not correct."""
    from repro_torch.serving import workers

    real = workers.DecodeWorker.inject_restored

    def off(dw, kv, idx):
        kv.v = kv.v * 1.02
        return real(dw, kv, idx)

    monkeypatch.setattr(workers.DecodeWorker, "inject_restored", off)
    res = _run(root)
    assert not res["correct"]
    assert res["checks"]["landed_mismatch"]["value"] > 0


@pytest.mark.parametrize("key,value", [("kv_lora_rank", 256),
                                       ("qk_rope_head_dim", 32),
                                       ("yarn_factor", 1.0),
                                       ("norm_topk_prob", True),
                                       ("dense_d_ff", 1408)])
def test_the_configuration_file_is_held_to_the_registry(key, value):
    cfg = json.loads((spec.BENCH_DIR / "configs" / "deepseek-v2-lite.json")
                     .read_text())
    spec.check_registry(cfg)
    with pytest.raises(ValueError, match=key):
        spec.check_registry(dict(cfg, **{key: value}))

"""The plain reference, held against small hand-checked cases and against
what the port derives from the same inputs today."""
import math

import numpy as np
import pytest
import torch

from reference import decoder, prompts, quant

PER_TOKEN = dict(quantizer="uniform", granularity="per_token",
                 symmetric=True, transform="none", codec="none")


def _strategy(bits, group):
    return dict(PER_TOKEN, key_bits=bits, value_bits=bits, group_size=group)


def test_qdq_by_hand():
    x = torch.tensor([[1.0, -0.45, 0.25, 0.126]])
    s16 = float(torch.tensor(1 / 127).half().float())
    # codes 127, -57 (-57.15), 32 (31.75), 16 (16.002)
    want = torch.tensor([[127, -57, 32, 16]]) * s16
    assert torch.equal(quant.qdq(x, _strategy(8, 4)), want)
    s4 = float(torch.tensor(1 / 7).half().float())
    # x / (1/7): 7, -3.15 -> -3, 1.75 -> 2, 0.882 -> 1
    assert torch.equal(quant.qdq(x, _strategy(4, 4)),
                       torch.tensor([[7, -3, 2, 1]]) * s4)
    ident = dict(PER_TOKEN, key_bits=16, value_bits=16, group_size=64)
    assert torch.equal(quant.qdq(torch.tensor([1 / 3]), ident),
                       torch.tensor([1 / 3]).half().float())
    with pytest.raises(ValueError):
        quant.qdq(x, dict(_strategy(8, 4), codec="zstd1"))


@pytest.mark.parametrize("bits,group", [(8, 64), (4, 32), (16, 64)])
def test_payload_decode_equals_the_port_and_the_plain_qdq(bits, group):
    from repro_torch.core.pipeline import CompressionPipeline, DeviceKVCache
    from repro_torch.core.strategy import StrategyConfig

    g = torch.Generator().manual_seed(bits)
    k = torch.randn((2, 3, 5, 64), generator=g)
    v = torch.randn((2, 3, 5, 64), generator=g)
    st = StrategyConfig(quantizer="uniform", key_bits=bits, value_bits=bits,
                        granularity="per_token", symmetric=True,
                        group_size=group)
    pipe = CompressionPipeline(st, device="cpu")
    comp = pipe.compress(DeviceKVCache(k, v))
    got_k, got_v = (t.numpy() for t in quant.payload_kv(comp, "cpu"))
    port = pipe.decompress(comp)
    assert np.array_equal(got_k, np.asarray(port.k, dtype=np.float32))
    assert np.array_equal(got_v, np.asarray(port.v, dtype=np.float32))
    sd = dict(PER_TOKEN, key_bits=bits, value_bits=bits, group_size=group)
    assert np.array_equal(got_k, quant.qdq(k, sd).numpy())


@pytest.mark.parametrize("workload", ["qalike", "codelike", "mathlike"])
@pytest.mark.parametrize("seed,seq", [(0, 64), (123456789, 1024),
                                      (2**33 + 5, 512)])
def test_prompt_ids_are_the_ports(workload, seed, seq):
    from repro_torch.core.quality import _prompts_for
    want, _ = _prompts_for(workload, 1, seq, seed)
    assert np.array_equal(prompts.prompt_ids(workload, seed, seq), want[0])


def test_rmsnorm_and_rope_by_hand():
    x = torch.tensor([[3.0, 4.0]])
    assert torch.allclose(decoder.rmsnorm(x, torch.zeros(2), 0.0),
                          x / math.sqrt(12.5))
    assert torch.allclose(decoder.rmsnorm(x, torch.ones(2), 0.0),
                          2 * x / math.sqrt(12.5))
    # D 2: one frequency theta^0 = 1; position 1 rotates by 1 radian
    q = torch.tensor([1.0, 0.0]).reshape(1, 1, 1, 2)
    got = decoder.rope(q.repeat(1, 2, 1, 1), torch.tensor([0, 1]), 1e4)
    assert torch.allclose(got[0, 0, 0], torch.tensor([1.0, 0.0]))
    assert torch.allclose(got[0, 1, 0],
                          torch.tensor([math.cos(1.0), math.sin(1.0)]))


def test_moe_capacity_drops_late_tokens_by_hand():
    d = 2
    p = {"router": torch.tensor([[10.0, -10.0], [0.0, 0.0]]),
         "wi_gate": torch.ones((2, d, 1)), "wi_up": torch.ones((2, d, 1)),
         "wo": torch.ones((2, 1, d))}
    cfg = {"num_experts": 2, "experts_per_token": 1, "capacity_factor": 1.0}
    x = torch.ones((1, 4, d))           # every token routes to expert 0
    y = decoder.moe(decoder.Plain(False), cfg, p, x, capacity=True)
    # cap = ceil(4 * 1 / 2 * 1.0) = 2: tokens 2 and 3 are dropped
    h = torch.nn.functional.silu(torch.tensor(2.0)) * 2.0
    assert torch.allclose(y[0, :2], torch.full((2, d), float(h)))
    assert torch.equal(y[0, 2:], torch.zeros((2, d)))
    y = decoder.moe(decoder.Plain(False), cfg, p, x, capacity=False)
    assert torch.allclose(y[0], torch.full((4, d), float(h)))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b-reduced",
                                  "qwen3-4b-reduced"])
def test_forward_agrees_with_the_port_at_a_tiny_size(arch):
    """The port's bf16 prefill and dense decode steps against the plain
    f32 pass on the same seeded weights, over a 16-bit profile: close to
    bf16 rounding, and the same greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import decode_step, prefill
    from kvb.weights import make_params

    cfg = get_config(arch)
    c = {"num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
         "kv_heads": cfg.kv_heads, "num_experts": cfg.num_experts,
         "experts_per_token": cfg.experts_per_token,
         "capacity_factor": cfg.capacity_factor, "qk_norm": cfg.qk_norm,
         "rope_theta": cfg.rope_theta, "rmsnorm_eps": cfg.rmsnorm_eps}
    params = make_params(cfg, 5, "cpu", decoder.init_scale)
    ids = torch.as_tensor(prompts.prompt_ids("qalike", 5, 32)[None],
                          dtype=torch.int32)
    logits, caches = prefill(cfg, params, {"tokens": ids}, 40)
    toks = [int(logits[0, -1].argmax())]
    steps = []
    for t in range(4):
        lg, caches = decode_step(cfg, params, caches,
                                 torch.tensor([[toks[-1]]],
                                              dtype=torch.int32),
                                 torch.tensor([32 + t], dtype=torch.int32))
        steps.append(lg[0, -1].float())
        toks.append(int(lg[0, -1].argmax()))
    ident = dict(PER_TOKEN, key_bits=16, value_bits=16, group_size=16)
    first, rest = decoder.forward(c, params, ids.long(),
                                  torch.tensor([toks[:-1]]), [ident])
    scale = float(first.abs().max())
    assert float((first[0] - logits[0, -1].float()).abs().max()) \
        < 0.05 * scale
    for t in range(4):
        assert float((rest[0, t] - steps[t]).abs().max()) < 0.05 * scale
    assert int(first[0].argmax()) == toks[0]

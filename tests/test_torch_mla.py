"""Multi-head latent attention (deepseek-v2-lite) in the port, on the CPU
at the reduced preset: the prefill, the paged decode through the
``paged_mla_attention`` kernel's plain version and the dense decode step
against the benchmark's plain f32 reference (``kvbench/reference/mla.py``,
no JAX counterpart exists), YaRN against the published formula, the
two-part cache through the pipeline, the router's ``norm_topk_prob`` and
deepseek-moe-16b's payloads as they were before caches had parts."""
import dataclasses
import hashlib
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

KVBENCH = Path(__file__).resolve().parents[1] / "kvbench"
if str(KVBENCH) not in sys.path:
    sys.path.insert(0, str(KVBENCH))

from reference import mla, prompts  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.kvcache import KVCache  # noqa: E402
from repro_torch.core.pipeline import (  # noqa: E402
    CompressionPipeline,
    DeviceKVCache,
)
from repro_torch.core.strategy import (  # noqa: E402
    IDENTITY_STRATEGY,
    StrategyConfig,
    quant_resident,
)
from repro_torch.kernels import paged_mla_attention_op  # noqa: E402
from repro_torch.kernels.ref import paged_mla_attention_ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    decode_step,
    init_params,
    prefill,
)
from repro_torch.utils.trees import _leaves  # noqa: E402

ARCH = "deepseek-v2-lite-reduced"
SEQ, STEPS = 32, 4
# The port's bf16 logits against the f32 reference, as a share of the
# largest reference logit: bf16 rounding of the activations, the latent
# and (decode) the absorbed query puts them 0.5-0.8% apart at this size;
# the fp8 control reads 7% here.  2% lies between.
TOL = 0.02
IDENT = dict(quantizer="uniform", granularity="per_token", symmetric=True,
             transform="none", codec="none", key_bits=16, value_bits=16,
             group_size=16)


def _published(c) -> dict:
    from test_kvbench_mla import published
    return published(c)


@pytest.fixture(scope="module")
def model():
    from kvb.weights import make_params
    # no expert drops: the reference's prompt pass and the port's see the
    # same capacity, and the comparison is of attention, not of drops
    cfg = dataclasses.replace(get_config(ARCH), capacity_factor=16.0)
    params = make_params(cfg, 5, "cpu", mla.init_scale)
    ids = torch.as_tensor(prompts.prompt_ids("codelike", 5, SEQ)[None],
                          dtype=torch.int32)
    return cfg, params, ids


def _reference(cfg, params, ids, served):
    c = dict(_published(cfg), capacity_factor=cfg.capacity_factor)
    return mla.forward(c, params, ids.long(), torch.tensor([served]),
                       [IDENT])


def _paged_decode(cfg, params, caches, first, page=16):
    """The prompt landed in a fresh slot of a paged arena (slot 1 of 2,
    slot 0 parked), then STEPS one-token steps through the arena's
    caches (the kernel's plain version on the CPU)."""
    from repro_torch.core.kvcache import PageTable
    from repro_torch.core.quality import (
        _paged_caches,
        _scatter_new_rows,
        copy_cache_slot_paged,
        init_paged_pools,
    )
    pps = -(-(SEQ + STEPS + 1) // page)
    pool, qc, qs = init_paged_pools(cfg, 2 * pps + 1, page, 1, "cpu")
    assert all(t.numel() == 0 for t in _leaves((qc, qs)))  # no quant pages
    pt = PageTable(2 * pps + 1, page)
    pt.ensure(1, SEQ + STEPS + 1)
    copy_cache_slot_paged(cfg, pool, caches, pt.block_row(1, pps), page)
    bt = torch.as_tensor(np.stack([pt.block_row(0, pps),
                                   pt.block_row(1, pps)]))
    toks, out = [first], []
    for t in range(STEPS):
        pos = torch.tensor([pps * page - 1, SEQ + t], dtype=torch.int32)
        lg, new = decode_step(cfg, params, _paged_caches(
            pool, qc, qs, bt, torch.zeros(2, dtype=torch.int32)),
            torch.tensor([[0], [toks[-1]]], dtype=torch.int32), pos)
        _scatter_new_rows(pool, new, bt, pos, page, 1)
        out.append(lg[1, -1].float())
        toks.append(int(lg[1, -1].argmax()))
    return toks, out


def _dense_decode(cfg, params, caches, first):
    toks, out = [first], []
    for t in range(STEPS):
        lg, caches = decode_step(cfg, params, caches,
                                 torch.tensor([[toks[-1]]], dtype=torch.int32),
                                 torch.tensor([SEQ + t], dtype=torch.int32))
        out.append(lg[0, -1].float())
        toks.append(int(lg[0, -1].argmax()))
    return toks, out


@pytest.mark.parametrize("arena", ["paged", "dense"])
def test_prefill_and_decode_against_the_reference(model, arena):
    """Prefill, then decoding through the cache (the paged arena's plain
    kernel, or the dense decode step), against the reference's full
    forward over the same tokens: logits within TOL of the largest."""
    cfg, params, ids = model
    with torch.no_grad():
        logits, caches = prefill(cfg, params, {"tokens": ids},
                                 SEQ + STEPS + 2)
        first = int(logits[0, -1].argmax())
        toks, steps = (_paged_decode if arena == "paged" else _dense_decode)(
            cfg, params, caches, first)
        ref_first, ref_rest = _reference(cfg, params, ids, toks[:-1])
    scale = float(ref_first.abs().max())
    assert float((ref_first[0] - logits[0, -1].float()).abs().max()) \
        < TOL * scale
    for t in range(STEPS):
        assert float((ref_rest[0, t] - steps[t]).abs().max()) < TOL * scale
    assert int(ref_first[0].argmax()) == first


def test_the_kernels_plain_version_is_dense_absorbed_attention():
    """``paged_mla_attention_op`` on CPU tensors (its plain version) is
    the absorbed attention over the gathered view: the scores over latent
    and rope key, the latent weighted; positions past kv_len and on the
    scratch page are unseen, so a parked row (table all 0) sees nothing."""
    g = torch.Generator().manual_seed(0)
    b, h, r, p, ps, pps = 3, 4, 32, 8, 4, 3
    lat = torch.randn(10, ps, 1, r, generator=g).to(torch.bfloat16)
    rope = torch.randn(10, ps, 1, p, generator=g).to(torch.bfloat16)
    q_abs = torch.randn(b, h, r, generator=g).to(torch.bfloat16)
    q_pe = torch.randn(b, h, p, generator=g).to(torch.bfloat16)
    bt = torch.tensor([[1, 2, 3], [4, 5, 0], [0, 0, 0]], dtype=torch.int32)
    lens = torch.tensor([11, 6, 11], dtype=torch.int32)
    out, m, lsum = paged_mla_attention_op(q_abs, q_pe, lat, rope, bt, lens,
                                          0.3)
    ref = paged_mla_attention_ref(q_abs, q_pe, lat, rope, bt, lens, 0.3)
    for got, want in zip((out, m, lsum), ref):
        assert torch.equal(got, want)
    for row in range(2):
        n = int(lens[row])
        kl = lat[bt[row].long()].reshape(-1, r)[:n].float()
        kr = rope[bt[row].long()].reshape(-1, p)[:n].float()
        s = (q_abs[row].float() @ kl.T + q_pe[row].float() @ kr.T) * 0.3
        assert torch.allclose(m[row], s.amax(-1))
        pr = torch.exp(s - s.amax(-1, keepdim=True))
        assert torch.allclose(lsum[row], pr.sum(-1))
        assert torch.allclose(out[row].float(), (pr @ kl).to(
            torch.bfloat16).float(), rtol=1e-2, atol=1e-2)
    assert torch.all(m[2] == -math.inf) and torch.all(lsum[2] == 0)
    assert torch.all(out[2] == 0)


def test_yarn_against_the_published_formula():
    """The published ``DeepseekV2YarnRotaryEmbedding``'s inverse
    frequencies (its f32 arithmetic, written out here) and attention
    factors at the full config: the port's within f32 rounding."""
    cfg = get_config("deepseek-v2-lite")
    dim, base, factor = cfg.qk_rope_head_dim, cfg.rope_theta, cfg.yarn_factor
    orig = cfg.yarn_original_max_position

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (
            2 * math.log(base))

    low, high = max(math.floor(corr(32)), 0), min(math.ceil(corr(1)),
                                                  dim - 1)
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32)
                           / dim)
    inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2,
                                                  dtype=torch.float32) / dim))
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    mask = 1 - ramp
    want = inter * (1 - mask) + extra * mask
    got = L.yarn_frequencies(cfg, dim)
    assert (low, high) == (10, 23)
    assert torch.allclose(got, want, rtol=1e-6, atol=0)
    assert float(got[0]) == 1.0 and got[-1] < extra[-1] / 39
    m = 0.1 * 0.707 * math.log(40) + 1
    assert L.yarn_get_mscale(40, 0.707) == pytest.approx(m)
    assert m == pytest.approx(1.2608, abs=1e-4)
    assert L.mla_softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m)


@pytest.mark.parametrize("bits", [16, 8, "hadamard"])
def test_a_two_part_cache_through_the_pipeline(bits):
    """A latent (L, 1, S, 32) beside a rope key (L, 1, S, 8): the identity
    round trip is bit-exact part by part; int8 per token (group 16: the
    latent in groups, the rope key clamped to one group a token) is
    within a step's half (step = group absmax / 127) plus 127 codes times
    the fp16 scale's rounding (2^-11 of it) of every element, on the host
    and through the device stages alike; through the Hadamard stage (each
    part rotated at its own width) within 1% by norm."""
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 1, 24, 32)).astype(np.float32)
    rope = (rng.standard_normal((2, 1, 24, 8)) * 3).astype(np.float32)
    kv = KVCache(lat, rope)
    assert kv.nbytes_wire() == (lat.size + rope.size) * 2
    st = IDENTITY_STRATEGY if bits == 16 else StrategyConfig(
        quantizer="uniform", key_bits=8, value_bits=8,
        granularity="per_token", symmetric=True, group_size=16,
        transform="hadamard" if bits == "hadamard" else "none")
    for src in (kv, DeviceKVCache.from_host(kv, "cpu")):
        pipe = CompressionPipeline(st, device="cpu")
        comp = pipe.compress(src)
        back = pipe.decompress(comp)
        assert comp.shape == lat.shape and comp.v_dims == rope.shape
        assert not quant_resident(comp)     # lands as bf16 pages
        assert comp.original_bytes() == kv.nbytes_wire()
        for got, x in ((back.k, lat), (back.v, rope)):
            got = np.asarray(got, dtype=np.float32)
            assert got.shape == x.shape
            if bits == 16:
                assert np.array_equal(got, x.astype(np.float16)
                                      .astype(np.float32))
            elif bits == "hadamard":
                assert np.linalg.norm(got - x) < 0.01 * np.linalg.norm(x)
            else:
                g = min(16, x.shape[-1])
                amax = np.abs(x.reshape(*x.shape[:-1], -1, g)).max(-1)
                bound = np.repeat(amax / 127 * (0.5 + 127 * 2.0 ** -11),
                                  g, axis=-1)
                assert np.all(np.abs(got - x) <= bound + 1e-6)


def test_norm_topk_prob_renormalises_only_when_set():
    cfg = get_config(ARCH)
    params = init_params(cfg, seed=1, device="cpu")
    router = {"router": params["blocks"]["layer1"]["mlp"]["router"][0]}
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    probs, w_off, ids_off = L.moe_route(router, cfg, x)
    _, w_on, ids_on = L.moe_route(
        router, dataclasses.replace(cfg, norm_topk_prob=True), x)
    assert torch.equal(ids_off, ids_on)
    assert torch.equal(w_off, probs.gather(-1, ids_off))
    assert torch.allclose(w_on, w_off / w_off.sum(-1, keepdim=True))
    assert float(w_off.sum(-1).max()) < 1.0


# deepseek-moe-16b's wire form on a fixed cache, recorded before caches
# had parts of their own widths: total bytes and a digest of every
# payload, scale and index array (host and device pipelines agree)
MHA_PAYLOADS = {
    (16, 64): (3670080, "cb56ddff9fb96d81"),
    (8, 64): (1896000, "f8155c4547381478"),
    (8, 128): (1867328, "a34477bd13e5258b"),
    (4, 64): (978496, "7f67a798d4e65f5f"),
    (4, 32): (1035840, "a5eeb47dc969e1a9"),
}


def _digest(comp) -> str:
    h = hashlib.sha256()
    if comp.identity_payload is not None:
        h.update(comp.identity_payload)
    for w in comp.k_buckets + comp.v_buckets:
        h.update(w.payload)
        for a in (w.scale, w.zp, w.token_index, w.lh_index):
            if a is not None:
                h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("bits,group", sorted(MHA_PAYLOADS))
def test_deepseek_moe_16b_payloads_are_unchanged(bits, group):
    cfg = get_config("deepseek-moe-16b")
    kv = KVCache.random(num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
                        seq=16, head_dim=cfg.resolved_head_dim, seed=7)
    st = IDENTITY_STRATEGY if bits == 16 else StrategyConfig(
        quantizer="uniform", key_bits=bits, value_bits=bits,
        granularity="per_token", symmetric=True, group_size=group)
    for src in (kv, DeviceKVCache.from_host(kv, "cpu")):
        comp = CompressionPipeline(st).compress(src)
        assert comp.v_shape is None and quant_resident(comp) == (bits < 16)
        assert (comp.total_bytes(), _digest(comp)) == MHA_PAYLOADS[(bits,
                                                                    group)]

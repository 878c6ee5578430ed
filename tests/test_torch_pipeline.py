"""The port's compression pipeline against the JAX package's.

A paged-eligible strategy applied to KV held as torch tensors
(:class:`repro_torch.core.pipeline.DeviceKVCache`) quantizes through
``quant_pack_op`` (its plain version on the CPU) and decompresses through
``dequant_unpack_op``; the wire form — payload bytes, fp16 scales, index
metadata, ``total_bytes()`` — must be the JAX package's host pipeline's
byte for byte, and the restored KV its ``decompress`` bit for bit.  Every
other strategy takes the copied numpy stages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.kvcache import KVCache as JKV  # noqa: E402
from repro.core.pipeline import CompressionPipeline as JPipe  # noqa: E402
from repro.core.strategy import BASELINES, StrategyConfig  # noqa: E402
from repro.serving.workers import quant_entry_arrays as j_entry  # noqa: E402
from repro_torch.core.pipeline import (  # noqa: E402
    CompressionPipeline,
    DeviceKVCache,
)
from repro_torch.core.strategy import StrategyConfig as PStrategy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.workers import quant_entry_arrays  # noqa: E402


def _kv(seed, bf16_exact):
    kv = JKV.random(num_layers=3, kv_heads=2, seq=37, head_dim=64, seed=seed)
    if bf16_exact:  # what a bf16 prefill cache holds
        def cast(a):
            return torch.from_numpy(a).to(torch.bfloat16).float().numpy()
        kv = JKV(cast(kv.k), cast(kv.v))
    return kv


def _device(kv):
    return DeviceKVCache(torch.from_numpy(kv.k.copy()),
                         torch.from_numpy(kv.v.copy()))


def _assert_same_wire(got, want):
    assert got.total_bytes() == want.total_bytes()
    assert got.payload_bytes() == want.payload_bytes()
    assert tuple(got.shape) == tuple(want.shape)
    for gb, wb in zip(got.k_buckets + got.v_buckets,
                      want.k_buckets + want.v_buckets):
        assert gb.payload == wb.payload
        assert (gb.bits, gb.grouping, gb.group_size, gb.symmetric,
                gb.codes_shape) == (wb.bits, wb.grouping, wb.group_size,
                                    wb.symmetric, wb.codes_shape)
        np.testing.assert_array_equal(gb.lh_index, wb.lh_index)
        assert gb.scale.dtype == wb.scale.dtype == np.float16
        np.testing.assert_array_equal(gb.scale, wb.scale)
        if wb.zp is None:
            assert gb.zp is None
        else:
            np.testing.assert_array_equal(gb.zp, wb.zp)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("bf16_exact", [True, False])
def test_device_path_wire_bytes_match_jax(bits, bf16_exact):
    kv = _kv(bits, bf16_exact)
    kw = dict(quantizer="uniform", key_bits=bits, value_bits=bits,
              granularity="per_token", symmetric=True, group_size=32)
    want = JPipe(StrategyConfig(**kw)).compress(kv)
    before = ops.quant_pack_op.launches
    got = CompressionPipeline(PStrategy(**kw)).compress(_device(kv))
    assert ops.quant_pack_op.launches == before   # CPU: the plain version
    _assert_same_wire(got, want)

    restored = CompressionPipeline(PStrategy(**kw), device="cpu") \
        .decompress(got)
    assert isinstance(restored, DeviceKVCache)
    ref = JPipe(StrategyConfig(**kw)).decompress(want)
    np.testing.assert_array_equal(restored.k.numpy(), ref.k)
    np.testing.assert_array_equal(restored.v.numpy(), ref.v)
    # the page-pool form a paged-eligible pool hit lands as
    for (gc, gs), (wc, ws) in zip(quant_entry_arrays(got), j_entry(want)):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gs, ws)


@pytest.mark.parametrize("name,kw", [
    ("per_channel", dict(quantizer="uniform", key_bits=8, value_bits=8,
                         granularity="per_channel")),
    ("identity", dict(key_bits=16, value_bits=16, codec="none")),
    ("zstd_per_token", dict(quantizer="uniform", key_bits=4, value_bits=4,
                            granularity="per_token", symmetric=True,
                            group_size=32, codec="zstd3")),
    ("kivi", None),
])
def test_other_strategies_take_the_host_path(name, kw):
    """Not paged-eligible: device KV goes through the copied numpy stages,
    with the JAX package's bytes and restored values."""
    kv = _kv(11, True)
    if kw is None:
        jcfg = BASELINES[name]
        pcfg = PStrategy.from_json(jcfg.to_json())
    else:
        jcfg, pcfg = StrategyConfig(**kw), PStrategy(**kw)
    want = JPipe(jcfg).compress(kv)
    got = CompressionPipeline(pcfg).compress(_device(kv))
    assert got.total_bytes() == want.total_bytes()
    if want.identity_payload is not None:
        assert got.identity_payload == want.identity_payload
    else:
        _assert_same_wire(got, want)
    restored = CompressionPipeline(pcfg, device="cpu").decompress(got)
    ref = JPipe(jcfg).decompress(want)
    np.testing.assert_array_equal(np.asarray(restored.k), ref.k)
    np.testing.assert_array_equal(np.asarray(restored.v), ref.v)


def test_device_kv_cache_accounts_like_host():
    kv = _kv(3, True)
    dev = _device(kv)
    assert dev.nbytes_wire() == kv.nbytes_wire()
    host = dev.to_host()
    np.testing.assert_array_equal(host.k, kv.k)

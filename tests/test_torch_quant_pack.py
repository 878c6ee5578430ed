"""quant_pack on the rows that sit on its rounding boundaries (CPU).

``repro_torch.kernels.quant_boundary.boundary_rows`` builds groups whose
quotients ``x / scale`` fall exactly on a .5, one step of the input's grid
from it, where the reciprocal shortcut moves a code, at +-qmax, all zero
and below the 1e-8 scale floor.  On them the port's ``quant_pack_op`` (its
plain version, on the CPU) must equal, bit for bit:

* the host quantizer ``core/quantizers.py::group_quantize`` (the wire
  contract: offset codes and fp16 scales), and
* the JAX package's Pallas ``quant_pack`` in interpret mode, compiled with
  XLA's algebraic simplifier off, so that each divide stays a divide: by
  default the simplifier turns ``amax / qmax`` into a multiply by the
  reciprocal of qmax, and the Pallas kernel then differs from the host
  quantizer on these rows (``test_pallas_default_compile_is_not_exact``).

``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold the CUDA kernel
against the plain version on the same rows on the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.quantizers import group_dequantize, group_quantize  # noqa: E402
from repro.kernels.quant_pack import dequant_unpack, quant_pack  # noqa: E402
from repro_torch.kernels import dequant_unpack_op, quant_pack_op  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels.quant_boundary import (  # noqa: E402
    KINDS,
    boundary_rows,
    reciprocal_differs,
    round_bf16,
    step,
)

D = 128


def _as_written(fn, *args):
    """``fn(*args)`` compiled with XLA's algebraic simplifier off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})(*args)


def _pallas(x: np.ndarray, bits: int, group: int, bf16: bool):
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    c, s = _as_written(functools.partial(
        quant_pack, bits=bits, group=group, interpret=True), jx)
    return np.asarray(c), np.asarray(s)


def _port(x: np.ndarray, bits: int, group: int, bf16: bool):
    t = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
    return quant_pack_op(t, bits=bits, group=group)


def _wire(codes: torch.Tensor, bits: int) -> np.ndarray:
    """The port's codes as the host quantizer's offset uint8 codes."""
    c = R.unpack_int4_ref(codes) if bits == 4 else codes
    return (c.to(torch.int16) + (1 << (bits - 1))).to(torch.uint8).numpy()


@pytest.mark.parametrize("t", [1, 77, 4097])
@pytest.mark.parametrize("group", [32, 64, 128])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_quant_pack_boundary_rows_bit_for_bit(bf16, bits, group, t):
    x = boundary_rows(t, D, group, bits, bf16, seed=t + group + bits)
    codes, scales = _port(x, bits, group, bf16)
    host_codes, host_scales, _ = group_quantize(
        x.reshape(1, t, D), bits, "per_token", group, True)
    np.testing.assert_array_equal(_wire(codes, bits).reshape(
        host_codes.shape), host_codes)
    np.testing.assert_array_equal(
        scales.to(torch.float16).numpy().reshape(host_scales.shape),
        host_scales)
    p_codes, p_scales = _pallas(x, bits, group, bf16)
    np.testing.assert_array_equal(codes.numpy(), p_codes)
    np.testing.assert_array_equal(scales.numpy(), p_scales)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_boundary_rows_are_adversarial(bf16, bits):
    """The rows hold every kind, are exact in the input type, put quotients
    on .5 and catch the shortcuts a kernel might take."""
    group = 64
    x = boundary_rows(4097, D, group, bits, bf16, seed=5)
    if bf16:
        np.testing.assert_array_equal(x, round_bf16(x))
    qmax = (1 << (bits - 1)) - 1
    xg = x.reshape(-1, group)
    amax = np.abs(xg).max(axis=1, keepdims=True)
    scale = np.maximum(amax / np.float32(qmax), np.float32(1e-8))
    quot = xg / scale
    assert (np.abs(quot - np.trunc(quot)) == 0.5).sum() > 10_000
    assert (amax == 0).sum() > 100
    assert (scale == np.float32(1e-8)).sum() > (amax == 0).sum()
    assert reciprocal_differs(xg, scale).sum() > 100
    # kinds are spread so that seven groups hold all of them
    assert len(KINDS) == 7
    # each shortcut moves codes on these rows, so the tests would see it
    codes, _ = _port(x, bits, group, bf16)
    want = codes.numpy().astype(np.int64)
    if bits == 4:
        want = R.unpack_int4_ref(codes).numpy().astype(np.int64)
    for name, q in (
            ("reciprocal", np.rint(xg * (np.float32(1) / scale))),
            ("half away from zero", np.trunc(quot + np.copysign(
                np.float32(0.5), quot)))):
        q = np.clip(q, -qmax - 1, qmax).astype(np.int64).reshape(want.shape)
        assert (q != want).sum() > 0, name


def test_pallas_default_compile_is_not_exact():
    """Why the Pallas kernel is compiled with the simplifier off: compiled
    whole by default, XLA rewrites its divides and it leaves the host
    quantizer on boundary rows (the port follows the host quantizer)."""
    x = boundary_rows(4097, D, 64, 8, False, seed=3)
    jx = jnp.asarray(x)
    c, s = jax.jit(functools.partial(
        quant_pack, bits=8, group=64, interpret=True))(jx)
    codes, scales = _port(x, 8, 64, False)
    assert not np.array_equal(np.asarray(s), scales.numpy())
    assert not np.array_equal(np.asarray(c), codes.numpy())


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("case", ["group6", "odd_offset", "t1"])
def test_quant_pack_scalar_path_shapes(case, bits):
    """The shapes the CUDA kernel sends to its scalar path, on the plain
    version: group 6 at D 96, an x at an odd element offset, T 1."""
    group, d, t = (6, 96, 77) if case == "group6" else (64, D, 77)
    if case == "t1":
        t = 1
    x = boundary_rows(t, d, group, bits, True, seed=11)
    if case == "odd_offset":
        flat = torch.zeros(t * d + 1, dtype=torch.bfloat16)
        flat[1:] = torch.from_numpy(x.ravel()).to(torch.bfloat16)
        xt = flat[1:].view(t, d)
        assert xt.storage_offset() == 1 and xt.is_contiguous()
    else:
        xt = torch.from_numpy(x).to(torch.bfloat16)
    codes, scales = quant_pack_op(xt, bits=bits, group=group)
    host_codes, host_scales, _ = group_quantize(
        x.reshape(1, t, d), bits, "per_token", group, True)
    np.testing.assert_array_equal(_wire(codes, bits).reshape(
        host_codes.shape), host_codes)
    np.testing.assert_array_equal(
        scales.to(torch.float16).numpy().reshape(host_scales.shape),
        host_scales)


@pytest.mark.parametrize("t", [1, 77, 4097])
@pytest.mark.parametrize("bits", [4, 8])
def test_dequant_unpack_boundary_codes_bit_for_bit(bits, t):
    """The codes of the boundary rows, restored: equal to the host's
    group_dequantize (fp16 scales) and to the Pallas dequant_unpack."""
    group = 64
    x = boundary_rows(t, D, group, bits, False, seed=t)
    host_codes, host_scales, zp = group_quantize(
        x.reshape(1, t, D), bits, "per_token", group, True)
    want = group_dequantize(host_codes, host_scales, zp, bits, "per_token",
                            group, True).reshape(t, D)
    signed = (host_codes.astype(np.int16) - (1 << (bits - 1))).reshape(t, D)
    codes = torch.from_numpy(signed.astype(np.int8))
    if bits == 4:
        codes = R.pack_int4_ref(codes)
    scales = torch.from_numpy(host_scales.astype(np.float32).reshape(t, -1))
    got = dequant_unpack_op(codes, scales, bits=bits, group=group,
                            out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    jc = jnp.asarray(codes.numpy())
    pallas = _as_written(functools.partial(
        dequant_unpack, bits=bits, group=group, out_dtype=jnp.float32,
        interpret=True), jc, jnp.asarray(scales.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    got_bf16 = dequant_unpack_op(codes, scales, bits=bits, group=group,
                                 out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got_bf16.float().numpy(),
                                  round_bf16(want))


def test_grid_steps():
    """``step`` walks the f32 and bf16 grids through zero and signs."""
    one = np.float32(1.0)
    assert step(one, 1, False) == np.nextafter(one, np.float32(2))
    assert step(one, -1, False) == np.nextafter(one, np.float32(0))
    assert step(one, 1, True) == np.float32(1.0078125)
    assert step(np.float32(-1.0), 1, True) == np.float32(-0.99609375)
    assert step(np.float32(0.0), -1, False) == -np.float32(1.4e-45)
    np.testing.assert_array_equal(
        step(np.float32([2.0, -2.0]), np.array([-2, 2]), True),
        np.float32([1.984375, -1.984375]))

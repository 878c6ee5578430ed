"""Rows that sit on the group quantizer's rounding boundaries (numpy only).

``quant_pack`` must give ``core/quantizers.py::group_quantize``'s codes bit
for bit: ``scale = max(amax / qmax, 1e-8)`` and ``q = rint(x / scale)``,
an IEEE f32 divide rounded half to even.  Random rows seldom land where a
shortcut (a multiply by the reciprocal of the scale, an approximate
divide, rounding half away from zero) differs, so :func:`boundary_rows`
builds groups that do, one kind per group:

  half        a power-of-two scale (``amax = qmax * 2^-k``) and elements
              ``(m + 0.5) * 2^-k``: every quotient is exactly on a .5
  half_ulp    the same moved one step of the input's grid (f32 or bf16)
              up or down, the amax element too in half of the groups
  reciprocal  elements near ``(m + 0.5) * scale`` on which
              ``rint(x * fl(1/scale)) != rint(x / scale)`` in f32, found
              by search among up to three grid steps of each ``.5``
  qmax        elements at and near +-amax and +-(qmax - 0.5) * scale
  zero        an all-zero group (scale 1e-8, codes 0)
  tiny        amax below ``qmax * 1e-8`` (the scale clamps to 1e-8), with
              subnormal elements
  random      ``3 * randn``, the rows the tests used before

Every value is representable in the requested input type, so the rows
reach the quantizer unchanged as f32 or bf16.
"""
from __future__ import annotations

import numpy as np

KINDS = ("half", "half_ulp", "reciprocal", "qmax", "zero", "tiny",
         "random")


def round_bf16(x) -> np.ndarray:
    """Each f32 value rounded to the nearest bf16 (ties to even), as f32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def step(x, n, bf16: bool) -> np.ndarray:
    """``x`` moved ``n`` representable values up (down for n < 0) on the
    grid of f32 or of bf16."""
    shift = 16 if bf16 else 0
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.int64) >> shift
    top = 31 - shift
    mag = u & ((1 << top) - 1)
    o = np.where(u >> top, -mag, mag) + n
    u = ((o < 0).astype(np.int64) << top) | np.abs(o)
    return (u << shift).astype(np.uint32).view(np.float32)


def reciprocal_differs(x, scale) -> np.ndarray:
    """Where the reciprocal shortcut moves a code: ``rint(x * fl(1/s))``
    against ``rint(x / s)``, in f32."""
    x = np.asarray(x, np.float32)
    s = np.asarray(scale, np.float32)
    return np.rint(x * (np.float32(1) / s)) != np.rint(x / s)


def _scale(amax, qmax) -> np.ndarray:
    return np.maximum(np.asarray(amax, np.float32) / np.float32(qmax),
                      np.float32(1e-8))


def _kind(kind, n, group, qmax, bf16, rng) -> np.ndarray:
    """``n`` groups of ``kind``; element 0 carries the group's amax."""
    to = round_bf16 if bf16 else (lambda v: np.asarray(v, np.float32))
    sign = rng.choice(np.float32([-1, 1]), size=(n, group))
    m = rng.integers(-qmax, qmax, size=(n, group)).astype(np.float32)
    if kind in ("half", "half_ulp"):
        s = np.exp2(-rng.integers(2, 21, size=(n, 1))).astype(np.float32)
        g = (m + np.float32(0.5)) * s
        g[:, 0] = qmax * s[:, 0] * sign[:, 0]
        if kind == "half_ulp":
            moved = rng.choice([-1, 1], size=(n, group))
            moved[:, 0] *= rng.integers(0, 2, size=n)
            g = step(g, moved, bf16)
        return g
    amax = to(np.exp2(rng.uniform(-4, 4, size=(n, 1))))
    s = _scale(amax, qmax)
    if kind == "reciprocal":
        mm = np.arange(-qmax, qmax, dtype=np.float32)
        c = to((mm + np.float32(0.5)) * s)[..., None]            # (n, M, 1)
        c = step(c, np.arange(-3, 4), bf16).reshape(n, -1)       # (n, M*7)
        hit = reciprocal_differs(c, s) & (np.abs(c) < amax)
        # the differing candidates first, in random order, then the rest
        key = rng.random(c.shape) + 2 * hit
        take = np.argsort(-key, axis=1)[:, :group]
        g = np.take_along_axis(c, take, axis=1)
        if g.shape[1] < group:
            g = np.tile(g, (1, -(-group // g.shape[1])))[:, :group]
        g = np.minimum(np.abs(g), amax) * np.sign(g)
        g[:, 0] = amax[:, 0]
        return g * sign
    if kind == "qmax":
        c = np.concatenate([
            amax, step(amax, -1, bf16), step(amax, -2, bf16),
            step(to(qmax * s), np.arange(-2, 1), bf16),
            step(to((qmax - np.float32(0.5)) * s), np.arange(-2, 3), bf16),
            step(to((qmax - np.float32(1.5)) * s), np.arange(-1, 2), bf16)],
            axis=1)
        c = np.minimum(c, amax)
        g = np.take_along_axis(
            c, rng.integers(0, c.shape[1], size=(n, group)), axis=1)
        g[:, 0] = amax[:, 0]
        return g * sign
    if kind == "zero":
        return np.zeros((n, group), np.float32)
    if kind == "tiny":
        amax = to(np.exp2(rng.uniform(-30, np.log2(qmax * 1e-8),
                                      size=(n, 1))))
        g = to(rng.uniform(-1, 1, size=(n, group)) * amax)
        g[:, 1::4] = to(np.float32(1e-40)) * sign[:, 1::4]
        g[:, 0] = amax[:, 0]
        return g * sign[:, :1]
    if kind == "random":
        return to(rng.standard_normal((n, group)) * 3)
    raise ValueError(kind)


def boundary_rows(t: int, d: int, group: int, bits: int, bf16: bool,
                  seed: int = 0) -> np.ndarray:
    """(t, d) f32 rows of boundary groups (``KINDS``, spread over the
    groups in a seeded order, so every kind appears once there are seven
    groups), each value representable as bf16 when ``bf16``."""
    if d % group or group % 2 or bits not in (4, 8):
        raise ValueError(f"boundary_rows: d={d} group={group} bits={bits}")
    rng = np.random.default_rng(seed)
    qmax = (1 << (bits - 1)) - 1
    n = t * d // group
    kind_of = rng.permutation(n) % len(KINDS)
    out = np.empty((n, group), np.float32)
    for k, kind in enumerate(KINDS):
        idx = np.nonzero(kind_of == k)[0]
        if idx.size:
            out[idx] = _kind(kind, idx.size, group, qmax, bf16, rng)
    out = rng.permuted(out, axis=1)
    return out.reshape(t, d)

"""Stage 3 of the pipeline: the Codec ``C`` (lossless entropy coding).

The paper uses nvCOMP on GPU; the TPU-native adaptation (DESIGN.md §3) keeps
bit-packing on device (Pallas kernel) and runs the entropy stage on the host
along the network path with **zstd** — itself an FSE/ANS entropy coder, the
closest faithful stand-in for nvCOMP's ANS.  ``bitshuffle`` transposes bit
planes first (CacheGen-style plane coding) which materially improves the
entropy stage on smooth quantized data.

``zstandard`` is an *optional* dependency (the ``zstd`` packaging extra).
Without it, the entropy stage falls back to the stdlib ``zlib`` (DEFLATE),
mapping each zstd level to a comparable zlib level.  The fallback is still
exactly lossless and byte accounting stays exact: wire bytes are always
``len()`` of whatever the active backend produced.  Encode and decode must
run with the same backend (payloads never persist across environments).

Everything here is exactly lossless (property-tested).
"""
from __future__ import annotations

import zlib
from typing import Tuple

import numpy as np

try:  # optional: the `zstd` packaging extra
    import zstandard as zstd
    HAVE_ZSTD = True
except ImportError:  # pragma: no cover - exercised by the no-zstd CI leg
    zstd = None
    HAVE_ZSTD = False

Array = np.ndarray


def backend() -> str:
    """Active entropy-coding backend: ``"zstd"`` or ``"zlib"``."""
    return "zstd" if HAVE_ZSTD else "zlib"


# ---------------------------------------------------------------------------
# Bit packing: uint8 codes with b significant bits -> dense bitstream.
# ---------------------------------------------------------------------------
def bitpack(codes: Array, bits: int) -> bytes:
    """Pack flat uint8 ``codes`` (< 2**bits) into a dense big-endian stream."""
    assert 1 <= bits <= 8
    flat = np.ascontiguousarray(codes, dtype=np.uint8).ravel()
    if bits == 8:
        return flat.tobytes()
    # (n, 8) bit matrix -> keep low ``bits`` columns -> repack.
    bitsmat = np.unpackbits(flat[:, None], axis=1)[:, 8 - bits :]
    return np.packbits(bitsmat.ravel()).tobytes()


def bitunpack(buf: bytes, bits: int, count: int) -> Array:
    """Inverse of :func:`bitpack`; returns uint8 array of length ``count``."""
    assert 1 <= bits <= 8
    if bits == 8:
        return np.frombuffer(buf, dtype=np.uint8, count=count).copy()
    raw = np.unpackbits(np.frombuffer(buf, dtype=np.uint8))
    raw = raw[: count * bits].reshape(count, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (raw * weights).sum(axis=1).astype(np.uint8)


# ---------------------------------------------------------------------------
# Bit-plane shuffle (improves zstd on quantized data).
# ---------------------------------------------------------------------------
def bitshuffle(codes: Array, bits: int) -> bytes:
    flat = np.ascontiguousarray(codes, dtype=np.uint8).ravel()
    planes = np.unpackbits(flat[:, None], axis=1)[:, 8 - bits :]  # (n, bits)
    return np.packbits(planes.T.ravel()).tobytes()


def bitunshuffle(buf: bytes, bits: int, count: int) -> Array:
    raw = np.unpackbits(np.frombuffer(buf, dtype=np.uint8))
    planes = raw[: count * bits].reshape(bits, count).T  # (n, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (planes * weights).sum(axis=1).astype(np.uint8)


# ---------------------------------------------------------------------------
# Codec dispatch.
# ---------------------------------------------------------------------------
_LEVELS = {"zstd1": 1, "zstd3": 3, "zstd10": 10, "bitshuffle_zstd3": 3}
# zlib fallback levels chosen to mirror the zstd speed/ratio ladder.
_ZLIB_LEVELS = {"zstd1": 1, "zstd3": 6, "zstd10": 9, "bitshuffle_zstd3": 6}


def _entropy_encode(raw: bytes, codec: str) -> bytes:
    if HAVE_ZSTD:
        return zstd.ZstdCompressor(level=_LEVELS[codec]).compress(raw)
    return zlib.compress(raw, _ZLIB_LEVELS[codec])


def _entropy_decode(buf: bytes) -> bytes:
    if HAVE_ZSTD:
        return zstd.ZstdDecompressor().decompress(buf)
    return zlib.decompress(buf)


def encode_codes(codes: Array, bits: int, codec: str) -> bytes:
    """codes (uint8, any shape) -> wire bytes for one bucket payload."""
    if codec == "none":
        return bitpack(codes, bits)
    if codec == "bitshuffle_zstd3":
        packed = bitshuffle(codes, bits)
    else:
        packed = bitpack(codes, bits)
    return _entropy_encode(packed, codec)


def decode_codes(buf: bytes, bits: int, count: int, codec: str) -> Array:
    if codec == "none":
        return bitunpack(buf, bits, count)
    packed = _entropy_decode(buf)
    if codec == "bitshuffle_zstd3":
        return bitunshuffle(packed, bits, count)
    return bitunpack(packed, bits, count)


def encode_f16(x: Array, codec: str) -> bytes:
    """Passthrough (bits>=16) buckets ship as raw/zstd'd fp16."""
    raw = np.ascontiguousarray(x, dtype=np.float16).tobytes()
    if codec == "none":
        return raw
    return _entropy_encode(raw, codec)


def decode_f16(buf: bytes, count: int, codec: str) -> Array:
    raw = buf if codec == "none" else _entropy_decode(buf)
    return np.frombuffer(raw, dtype=np.float16, count=count).copy()

"""Canonical host-side KV cache container used on the network path, and
the page-table bookkeeping for the paged decode arena (DESIGN.md §12).

Layout: ``k, v : (num_layers, kv_heads, seq, head_dim)`` float32 arrays that
*logically* represent bf16 wire data (2 bytes/elem), matching the paper's
BF16 baseline accounting.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from repro_torch.core.strategy import SCALE_BYTES, SOURCE_BYTES


@dataclass
class KVCache:
    k: np.ndarray  # (L, H, S, D)
    v: np.ndarray  # (L, H, S, D)

    def __post_init__(self):
        assert self.k.shape == self.v.shape, (self.k.shape, self.v.shape)
        assert self.k.ndim == 4

    @property
    def shape(self):
        return self.k.shape

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def kv_heads(self) -> int:
        return self.k.shape[1]

    @property
    def seq(self) -> int:
        return self.k.shape[2]

    @property
    def head_dim(self) -> int:
        return self.k.shape[3]

    def nbytes_wire(self) -> int:
        """Bytes of the uncompressed payload on the wire (logical bf16)."""
        return int(self.k.size + self.v.size) * SOURCE_BYTES

    @staticmethod
    def random(num_layers=4, kv_heads=4, seq=128, head_dim=64, seed=0,
               scale: float = 1.0) -> "KVCache":
        rng = np.random.default_rng(seed)
        shape = (num_layers, kv_heads, seq, head_dim)
        # Heavy-tailed, channel-structured data resembling real KV statistics:
        # per-channel means + a few outlier channels (motivating Hadamard).
        base_k = rng.standard_normal(shape).astype(np.float32)
        base_v = rng.standard_normal(shape).astype(np.float32)
        chan_scale = np.exp(rng.standard_normal((1, 1, 1, head_dim)) * 0.5)
        outliers = rng.random((1, 1, 1, head_dim)) < 0.03
        chan_scale = chan_scale * np.where(outliers, 8.0, 1.0)
        k = (base_k * chan_scale + rng.standard_normal((1, 1, 1, head_dim))) * scale
        v = base_v * scale
        return KVCache(k.astype(np.float32), v.astype(np.float32))

    def allclose(self, other: "KVCache", atol=1e-5, rtol=1e-5) -> bool:
        return bool(
            np.allclose(self.k, other.k, atol=atol, rtol=rtol)
            and np.allclose(self.v, other.v, atol=atol, rtol=rtol)
        )


# ---------------------------------------------------------------------------
# Paged-arena page table (DESIGN.md §12)
# ---------------------------------------------------------------------------
class ArenaOutOfPages(RuntimeError):
    """The shared page pool is exhausted — a slot asked for more pages
    than the free list holds.  Admission control should have prevented
    this; raising (rather than silently corrupting a stolen page) keeps
    page ownership single-writer by construction."""


@dataclass
class PageTable:
    """Host-side bookkeeping for a paged KV arena.

    The device pools are ``(num_pages, page_size, ...)`` arrays; this
    table tracks which pool pages each slot owns.  Page 0 is reserved as
    the scratch page — it is never allocated, every unmapped block-table
    entry points at it, and parked/inert cache writes land in it, so
    real pages are single-writer: exactly one slot owns any page > 0.

    Invariants (checked by :meth:`check`):
      * ``len(free) + sum(len(pages[s]))  ==  num_pages - 1``
      * no page id appears twice (across the free list + all slots)
      * page 0 is never owned and never free-listed
    """

    num_pages: int
    page_size: int
    free: List[int] = field(default_factory=list)
    pages: Dict[int, List[int]] = field(default_factory=dict)

    def __post_init__(self):
        assert self.num_pages >= 2 and self.page_size >= 1
        if not self.free and not self.pages:
            # LIFO free list: recently released pages are re-used first
            # (they are the ones most likely still warm in cache).
            self.free = list(range(self.num_pages - 1, 0, -1))

    # -- capacity ------------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self.free)

    def ensure(self, slot: int, n_tokens: int) -> List[int]:
        """Grow ``slot`` to cover ``n_tokens`` positions, allocating pages
        on demand.  Returns the newly allocated page ids (often empty).
        Raises :class:`ArenaOutOfPages` when the pool cannot cover it —
        the slot keeps whatever it already owned (no partial grant)."""
        owned = self.pages.setdefault(slot, [])
        need = self.pages_for(n_tokens) - len(owned)
        if need <= 0:
            return []
        if need > len(self.free):
            raise ArenaOutOfPages(
                f"slot {slot} needs {need} more page(s) of {self.page_size} "
                f"tokens but only {len(self.free)} free of {self.num_pages}")
        new = [self.free.pop() for _ in range(need)]
        owned.extend(new)
        return new

    def release(self, slot: int) -> int:
        """Return all of ``slot``'s pages to the free pool."""
        owned = self.pages.pop(slot, [])
        self.free.extend(owned)
        return len(owned)

    def release_tail(self, slot: int, n_tokens: int) -> List[int]:
        """Shrink ``slot`` to the pages covering ``n_tokens`` positions,
        returning the freed page ids (often empty).  This is the
        speculative-decode rollback: a verify step may have ensured pages
        for ``k`` draft positions that were then rejected; the slot stays
        live and keeps its committed prefix, only the rejected tail pages
        go back to the free pool.  The freed pages need no scrubbing —
        reads are capped at the committed position, so whatever draft KV
        they hold is never attended to and is overwritten on reuse."""
        owned = self.pages.get(slot, [])
        keep = self.pages_for(n_tokens)
        freed = owned[keep:]
        del owned[keep:]
        self.free.extend(freed)
        return freed

    def block_row(self, slot: int, row_len: int) -> np.ndarray:
        """The slot's block-table row, padded with the scratch sentinel 0
        to ``row_len`` entries (row_len = ceil(max_len / page_size))."""
        owned = self.pages.get(slot, [])
        assert len(owned) <= row_len, (slot, len(owned), row_len)
        row = np.zeros(row_len, np.int32)
        row[:len(owned)] = owned
        return row

    def check(self) -> None:
        """Assert the conservation + single-ownership invariants."""
        seen = set(self.free)
        assert len(seen) == len(self.free), "free list holds duplicates"
        total = len(self.free)
        for slot, owned in self.pages.items():
            for p in owned:
                assert 0 < p < self.num_pages, (slot, p)
                assert p not in seen, f"page {p} double-owned"
                seen.add(p)
            total += len(owned)
        assert 0 not in seen, "scratch page 0 was allocated"
        assert total == self.num_pages - 1, (total, self.num_pages - 1)

    # -- byte accounting (capacity experiments) ------------------------
    @staticmethod
    def page_bytes_fp16(page_size: int, kv_heads: int, head_dim: int,
                        num_layers: int) -> int:
        """Logical HBM bytes of one fp16/bf16 K+V page across layers."""
        return 2 * num_layers * page_size * kv_heads * head_dim * SOURCE_BYTES

    @staticmethod
    def page_bytes_quant(page_size: int, kv_heads: int, head_dim: int,
                         num_layers: int, bits: int, group: int) -> int:
        """Logical HBM bytes of one quantized K+V page (codes + fp16
        scales at one scale per ``group`` channels per token)."""
        elems = num_layers * page_size * kv_heads * head_dim
        per_tensor = elems * bits // 8 + (elems // group) * SCALE_BYTES
        return 2 * per_tensor

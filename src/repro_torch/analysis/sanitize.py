"""Runtime KV sanitizer: ownership/liveness tracking for the paged arena
and the tiered store (DESIGN.md §14 — the dynamic counterpart of the
``ownership`` static rule).

The static rules catch MOVE-shaped *code*; this module catches MOVE/
lifetime bugs at *runtime*, where they would otherwise surface as silent
cross-request KV corruption long after the faulty call.  When installed
it wraps:

* :class:`~repro_torch.core.kvcache.PageTable` — **double-release** (a slot's
  pages returned to the free pool twice, so a later ``ensure`` can hand
  the same page to two slots; both the full ``release()`` and the
  speculative-rollback ``release_tail()`` are guarded, the latter at
  page granularity so legal partial rollbacks stay silent) and
  **use-after-release** (``block_row()`` on a released slot: the decode
  kernel would read scratch/garbage pages).
* :class:`~repro_torch.serving.kvstore.PrefixKVStore` (via its owning
  :class:`~repro_torch.serving.kvstore.KVTier`) — **shared-tier clobber**:
  ``discard()`` on a cluster-shared tier's store.  A shared tier's
  entries leave only by SLO-aware eviction or same-key replacement
  inside ``try_put_entry``; a MOVE-shaped ``discard`` removes a copy
  every other worker's hierarchy relies on (the COPY-not-MOVE bug class).
* :class:`~repro_torch.serving.workers.DecodeWorker` /
  :class:`~repro_torch.serving.cluster.ClusterRuntime` — **pages leaked at
  drain**: a freed slot that still owns pages, and, after a ``run()``
  that drained the scheduler, any page owned by a slot that is no
  longer live.

Switchable: ``install()`` / ``uninstall()`` patch the real classes in
place (state rides on the instances, so already-built objects are
covered too).  This copy patches the PyTorch package's own classes and
leaves the JAX package's alone (each copy keeps its own originals); the
port's test files install it from a fixture when ``REPRO_SANITIZE=1``,
as ``tests/conftest.py`` does for the JAX package's copy.  Violations
raise :class:`SanitizerError` with a ``kind`` tag so fault-injection
tests can assert the exact detector that fired.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

ENV_VAR = "REPRO_SANITIZE"

KINDS = ("double-release", "use-after-release", "leaked-pages",
         "shared-clobber")


class SanitizerError(RuntimeError):
    """A KV ownership/liveness violation caught at runtime."""

    def __init__(self, kind: str, message: str):
        assert kind in KINDS, kind
        super().__init__(f"[kv-sanitizer:{kind}] {message}")
        self.kind = kind


_installed = False
_orig: Dict[str, object] = {}


def enabled() -> bool:
    return _installed


def env_requested() -> bool:
    return os.environ.get(ENV_VAR, "") == "1"


# ---------------------------------------------------------------------------
# Explicit drain check (also wired into ClusterRuntime.run below)
# ---------------------------------------------------------------------------
def check_drained(table, live_slots: Iterable[int] = ()) -> None:
    """Assert that no slot outside ``live_slots`` still owns pages, and
    that the table's conservation invariants hold.  Call at any drain
    point (end of run, between workload phases)."""
    live = set(live_slots)
    leaked = {s: owned for s, owned in table.pages.items()
              if s not in live and owned}
    if leaked:
        detail = ", ".join(
            f"slot {s}: {len(p)} page(s)" for s, p in sorted(leaked.items()))
        raise SanitizerError(
            "leaked-pages",
            f"pages owned by non-live slots at drain ({detail}) — a "
            f"release path skipped page_table.release()")
    table.check()


# ---------------------------------------------------------------------------
# Wrappers (installed over the real classes; state lives per instance)
# ---------------------------------------------------------------------------
def _released_set(table) -> set:
    rel = getattr(table, "_san_released", None)
    if rel is None:
        rel = set()
        table._san_released = rel
    return rel


def _pt_ensure(self, slot: int, n_tokens: int):
    _released_set(self).discard(slot)      # (re)allocation revives the slot
    return _orig["PageTable.ensure"](self, slot, n_tokens)


def _pt_release(self, slot: int) -> int:
    rel = _released_set(self)
    if slot not in self.pages and slot in rel:
        raise SanitizerError(
            "double-release",
            f"slot {slot} released twice — its pages are already in the "
            f"free pool, so a concurrent ensure() could double-own them")
    rel.add(slot)
    return _orig["PageTable.release"](self, slot)


def _pt_release_tail(self, slot: int, n_tokens: int):
    # Speculative rollback (DESIGN.md §15) is a LEGAL partial release:
    # the slot stays live with its committed prefix and only the
    # rejected draft tail returns to the free pool, so it must not feed
    # the slot-level released set above.  The page-level hazard is a
    # rollback path freeing pages the slot no longer owns — the same
    # physical page landing in the free pool twice, double-grantable by
    # two later ensure() calls.
    owned = self.pages.get(slot, [])
    tail = owned[self.pages_for(n_tokens):]
    dup = sorted(set(tail) & set(self.free))
    if dup:
        raise SanitizerError(
            "double-release",
            f"speculative rollback on slot {slot} frees page(s) {dup} "
            f"that are already in the free pool — a rollback path "
            f"returned the tail twice")
    return _orig["PageTable.release_tail"](self, slot, n_tokens)


def _pt_block_row(self, slot: int, row_len: int):
    if slot in _released_set(self) and slot not in self.pages:
        raise SanitizerError(
            "use-after-release",
            f"block_row() on released slot {slot} — the decode kernel "
            f"would read scratch/garbage pages for this row")
    return _orig["PageTable.block_row"](self, slot, row_len)


def _kvtier_setattr(self, name: str, value) -> None:
    object.__setattr__(self, name, value)
    # keep the clobber guard in sync with the shared flag, whichever
    # order (shared=True then store swap, or the reverse) it is set in
    if name == "shared" and value:
        store = getattr(self, "store", None)
        if store is not None:
            store._san_shared_guard = True
    elif name == "store" and value is not None and \
            getattr(self, "shared", False):
        value._san_shared_guard = True


def _store_discard(self, tokens):
    if getattr(self, "_san_shared_guard", False):
        raise SanitizerError(
            "shared-clobber",
            f"discard() on a cluster-SHARED tier's store (key of "
            f"{len(tuple(tokens))} tokens) — shared-tier entries leave "
            f"only by eviction or same-key replace; a MOVE removes the "
            f"copy every other worker's hierarchy relies on")
    return _orig["PrefixKVStore.discard"](self, tokens)


def _dw_release(self, slot) -> None:
    _orig["DecodeWorker.release"](self, slot)
    pt = getattr(self, "page_table", None)
    if pt is not None and pt.pages.get(slot.idx):
        raise SanitizerError(
            "leaked-pages",
            f"decode worker {self.wid} freed slot {slot.idx} but it "
            f"still owns {len(pt.pages[slot.idx])} page(s)")


def _rt_run(self, max_steps: int = 10_000):
    out = _orig["ClusterRuntime.run"](self, max_steps)
    if self.scheduler.idle:
        for dw in self.decode_workers:
            if dw.page_table is not None:
                check_drained(
                    dw.page_table,
                    live_slots=[s.idx for s in dw.slots.values()])
    return out


# ---------------------------------------------------------------------------
def install() -> None:
    """Patch the KV classes in place (idempotent)."""
    global _installed
    if _installed:
        return
    from repro_torch.core.kvcache import PageTable
    from repro_torch.serving.cluster import ClusterRuntime
    from repro_torch.serving.kvstore import KVTier, PrefixKVStore
    from repro_torch.serving.workers import DecodeWorker

    _orig["PageTable.ensure"] = PageTable.ensure
    _orig["PageTable.release"] = PageTable.release
    _orig["PageTable.release_tail"] = PageTable.release_tail
    _orig["PageTable.block_row"] = PageTable.block_row
    _orig["KVTier.__setattr__"] = KVTier.__setattr__
    _orig["PrefixKVStore.discard"] = PrefixKVStore.discard
    _orig["DecodeWorker.release"] = DecodeWorker.release
    _orig["ClusterRuntime.run"] = ClusterRuntime.run

    PageTable.ensure = _pt_ensure
    PageTable.release = _pt_release
    PageTable.release_tail = _pt_release_tail
    PageTable.block_row = _pt_block_row
    KVTier.__setattr__ = _kvtier_setattr
    PrefixKVStore.discard = _store_discard
    DecodeWorker.release = _dw_release
    ClusterRuntime.run = _rt_run

    # NOTE: tiers flagged shared BEFORE install() are guarded from their
    # next .shared/.store assignment on; install before building the
    # runtime to cover construction-time flags.
    _installed = True


def uninstall() -> None:
    """Restore the original methods (idempotent)."""
    global _installed
    if not _installed:
        return
    from repro_torch.core.kvcache import PageTable
    from repro_torch.serving.cluster import ClusterRuntime
    from repro_torch.serving.kvstore import KVTier, PrefixKVStore
    from repro_torch.serving.workers import DecodeWorker

    PageTable.ensure = _orig.pop("PageTable.ensure")
    PageTable.release = _orig.pop("PageTable.release")
    PageTable.release_tail = _orig.pop("PageTable.release_tail")
    PageTable.block_row = _orig.pop("PageTable.block_row")
    KVTier.__setattr__ = _orig.pop("KVTier.__setattr__")
    PrefixKVStore.discard = _orig.pop("PrefixKVStore.discard")
    DecodeWorker.release = _orig.pop("DecodeWorker.release")
    ClusterRuntime.run = _orig.pop("ClusterRuntime.run")
    _installed = False


def install_from_env() -> bool:
    """Install iff ``REPRO_SANITIZE=1``; returns whether installed."""
    if env_requested():
        install()
        return True
    return False

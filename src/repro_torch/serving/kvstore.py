"""Compressed prefix-KV pool store (the paper's KV-disaggregated scenario).

The pool holds :class:`repro.core.pipeline.CompressedKV` payloads (or, for
the event-driven simulator, opaque payloads with the same byte accounting)
keyed by the token prefix that produced them.  Three properties matter for
reproducing the paper's TTFT path (Sec. 7.2 / Fig. 14):

  * **Prefix matching** — lookups walk block-aligned prefixes of the query
    tokens from longest to shortest, so a request whose prompt extends a
    stored prefix still hits (vLLM-style hash-chain prefix caching).
  * **Wire-byte capacity accounting** — the store is a *network-attached*
    pool; what occupies it is the compressed wire footprint, not logical
    KV bytes.  ``used_bytes == sum(entry.wire_bytes) <= capacity_bytes``
    is an invariant after every operation.
  * **SLO-aware LRU eviction** — victims are chosen lowest-SLO-class first
    (batch before standard before interactive), least-recently-used within
    a class, so latency-critical tenants keep their prefixes warm.

Since ISSUE 4 the flat pool generalizes to a :class:`TieredKVStore` — an
ordered memory hierarchy (device-adjacent HBM, host DRAM, remote pool).
Each tier owns a capacity, a serialized fetch link
(:class:`~repro.serving.network.KVWire` over its own
:class:`~repro.serving.network.BandwidthTrace`), and an optional demotion
re-compression profile.  Hits fetch from the tier that holds the prefix
and **promote** on access; capacity pressure **demotes** victims down the
hierarchy (re-compressing with the destination tier's profile) instead of
dropping them — only the last tier truly evicts.

Shared by the real-execution :class:`~repro.serving.engine.ServingRuntime`
and the event-driven :class:`~repro.serving.simulator.Simulator` so both
exercise one placement/eviction code path (DESIGN.md §9).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.network import BandwidthTrace, KVWire, WireTransfer

TokenKey = Tuple[int, ...]

# Rank of each SLO class; lower = more latency-critical = evicted last.
SLO_CLASSES: Dict[str, int] = {"interactive": 0, "standard": 1, "batch": 2}


def slo_rank(slo_class: str) -> int:
    return SLO_CLASSES.get(slo_class, SLO_CLASSES["standard"])


@dataclass
class StoreEntry:
    tokens: TokenKey          # full token prefix this entry caches
    payload: Any              # CompressedKV (+ first token) or sim stand-in
    wire_bytes: int           # compressed wire footprint (capacity unit)
    kv_bytes: float = 0.0     # uncompressed payload V (for fetch modelling)
    workload: str = ""
    slo_class: str = "standard"
    created: float = 0.0
    last_used: float = 0.0
    hits: int = 0

    @property
    def rank(self) -> int:
        return slo_rank(self.slo_class)


@dataclass
class StoreStats:
    hits: int = 0
    misses: int = 0
    # full=True lookups that found no full-coverage entry but DID have a
    # usable block-aligned partial prefix — not a true miss (the prefix is
    # warm; the consumer just can't top-up-prefill the uncovered suffix).
    partial_misses: int = 0
    evictions: int = 0
    # payload alone exceeded capacity, OR making room would have evicted
    # an entry of strictly more critical SLO rank (never allowed).
    rejected_puts: int = 0

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses + self.partial_misses
        return self.hits / n if n else 0.0


class PrefixKVStore:
    """Bounded pool of compressed KV prefixes with SLO-aware LRU eviction."""

    def __init__(self, capacity_bytes: int, block: int = 16):
        # capacity 0 is legal (a disabled tier in a TieredKVStore: every
        # put is oversize and falls through to the next tier).
        assert capacity_bytes >= 0 and block > 0
        self.capacity_bytes = int(capacity_bytes)
        self.block = int(block)
        self._entries: Dict[TokenKey, StoreEntry] = {}
        self.used_bytes = 0
        self.stats = StoreStats()

    # ------------------------------------------------------------------
    def _prefix_keys(self, tokens: TokenKey) -> List[TokenKey]:
        """Candidate keys, longest first: the full prefix, then every
        block-aligned truncation."""
        tokens = tuple(tokens)
        keys = [tokens]
        n = (len(tokens) - 1) // self.block * self.block
        while n > 0:
            keys.append(tokens[:n])
            n -= self.block
        return keys

    # ------------------------------------------------------------------
    def lookup(self, tokens: TokenKey, now: float = 0.0,
               full: bool = False) -> Optional[StoreEntry]:
        """Longest stored prefix of ``tokens`` (None on miss).  Updates
        recency and hit/miss counters.

        ``full=True`` only accepts an entry covering *all* of ``tokens`` —
        for consumers that cannot top-up-prefill the uncovered suffix of a
        partial prefix match (e.g. the real-execution runtime).

        Entries are only visible once their pool write has completed:
        ``put`` stamps ``created`` with the write-completion time, and a
        lookup at an earlier ``now`` misses (no time-travel hits)."""
        keys = ([tuple(tokens)] if full else self._prefix_keys(tokens))
        for key in keys:
            e = self._entries.get(key)
            if e is not None and e.created <= now:
                e.last_used = now
                e.hits += 1
                self.stats.hits += 1
                return e
        if full and any(
                e is not None and e.created <= now
                for e in (self._entries.get(k)
                          for k in self._prefix_keys(tokens)[1:])):
            # A usable partial prefix exists; the full=True consumer just
            # cannot exploit it.  Distinct from a cold miss.
            self.stats.partial_misses += 1
        else:
            self.stats.misses += 1
        return None

    def contains(self, tokens: TokenKey, now: float = 0.0) -> bool:
        """Exact-key presence under the same write-visibility rule as
        :meth:`lookup`: an entry whose pool write completes after ``now``
        is not visible yet (no time-traveling entries).  Does not touch
        recency or hit/miss counters."""
        e = self._entries.get(tuple(tokens))
        return e is not None and e.created <= now

    # ------------------------------------------------------------------
    def _evict_order(self) -> List[StoreEntry]:
        """Victims first: lowest SLO priority (highest rank), then LRU."""
        return sorted(self._entries.values(),
                      key=lambda e: (-e.rank, e.last_used))

    def _make_room(self, need: int, rank: int) -> Optional[List[StoreEntry]]:
        """Evict until ``need`` bytes fit, lowest-priority-first — but an
        insert of SLO rank ``rank`` must NEVER evict an entry of strictly
        more critical rank (lower number).  Returns the evicted entries,
        or None when room cannot be made without such an inversion (the
        caller rejects/demotes the insert; nothing is evicted then)."""
        if self.used_bytes + need <= self.capacity_bytes:
            return []
        eligible = [e for e in self._evict_order() if e.rank >= rank]
        freeable = sum(e.wire_bytes for e in eligible)
        if self.used_bytes - freeable + need > self.capacity_bytes:
            return None
        evicted: List[StoreEntry] = []
        while self.used_bytes + need > self.capacity_bytes:
            victim = eligible.pop(0)
            del self._entries[victim.tokens]
            self.used_bytes -= victim.wire_bytes
            self.stats.evictions += 1
            evicted.append(victim)
        return evicted

    # ------------------------------------------------------------------
    def discard(self, tokens: TokenKey) -> Optional[StoreEntry]:
        """Silently remove and return the exact-key entry (None if absent).
        No stats are touched — this is the tiered store's move primitive."""
        e = self._entries.pop(tuple(tokens), None)
        if e is not None:
            self.used_bytes -= e.wire_bytes
        return e

    # ------------------------------------------------------------------
    def try_put_entry(self, entry: StoreEntry
                      ) -> Tuple[str, List[StoreEntry]]:
        """Insert a pre-built entry.  Returns ``(status, evicted)`` with
        status ``"stored"`` | ``"oversize"`` (payload exceeds the whole
        pool) | ``"protected"`` (room would require evicting a strictly
        more critical SLO rank).  On non-stored statuses nothing is
        evicted and a pre-existing same-key entry is left in place."""
        entry.tokens = tuple(entry.tokens)
        entry.wire_bytes = int(entry.wire_bytes)
        if entry.wire_bytes > self.capacity_bytes:
            return "oversize", []
        old = self._entries.pop(entry.tokens, None)
        if old is not None:
            self.used_bytes -= old.wire_bytes
        evicted = self._make_room(entry.wire_bytes, entry.rank)
        if evicted is None:
            if old is not None:   # roll the refresh back untouched
                self._entries[entry.tokens] = old
                self.used_bytes += old.wire_bytes
            return "protected", []
        self._entries[entry.tokens] = entry
        self.used_bytes += entry.wire_bytes
        assert self.used_bytes <= self.capacity_bytes
        return "stored", evicted

    def put(self, tokens: TokenKey, payload: Any, wire_bytes: int,
            kv_bytes: float = 0.0, workload: str = "",
            slo_class: str = "standard", now: float = 0.0
            ) -> List[StoreEntry]:
        """Insert (or refresh) the entry for ``tokens``, evicting until it
        fits.  Returns the evicted entries.  A payload larger than the
        whole pool — or one that could only fit by evicting a strictly
        more critical SLO class — is rejected (counted, nothing evicted)."""
        entry = StoreEntry(
            tokens=tuple(tokens), payload=payload, wire_bytes=int(wire_bytes),
            kv_bytes=kv_bytes, workload=workload, slo_class=slo_class,
            created=now, last_used=now)
        status, evicted = self.try_put_entry(entry)
        if status != "stored":
            self.stats.rejected_puts += 1
            return []
        return evicted

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def free_bytes(self) -> int:
        return self.capacity_bytes - self.used_bytes

    def entries(self) -> List[StoreEntry]:
        return list(self._entries.values())

    def summary(self) -> Dict[str, float]:
        return {
            "entries": len(self._entries),
            "used_bytes": self.used_bytes,
            "capacity_bytes": self.capacity_bytes,
            "hit_rate": self.stats.hit_rate,
            "hits": self.stats.hits,
            "misses": self.stats.misses,
            "partial_misses": self.stats.partial_misses,
            "evictions": self.stats.evictions,
            "rejected_puts": self.stats.rejected_puts,
        }


# ===========================================================================
# Tiered memory hierarchy (ISSUE 4 tentpole)
# ===========================================================================
@dataclass
class TierSpec:
    """Declarative description of one tier of the KV memory hierarchy."""

    name: str                     # "hbm" | "dram" | "remote" | ...
    capacity_bytes: int           # wire-byte capacity (0 = disabled tier)
    # Fetch link: a bytes/s constant or a full BandwidthTrace.  The link is
    # ONE serialized queue (half-duplex): fetches, pool writes and demotion
    # traffic into this tier all contend on it.
    bandwidth: Any = 10 * (1 << 30)
    fetch_overhead: float = 0.0   # per-fetch RPC/setup cost (s)
    # Demotion policy: entries demoted INTO this tier are re-compressed
    # with this profile (when the owner installed a `recompress` hook and
    # it actually shrinks the payload).  None = keep the stored encoding.
    profile: Optional[Any] = None
    # Feed this tier's on-wire goodput to the shared estimator (the
    # controller's B).  Only the remote/pool tier should: local-tier
    # goodput would inflate the network estimate.
    observe_goodput: bool = False


class KVTier:
    """A built tier: its bounded store + its serialized fetch link.

    ``shared=True`` marks a tier that several TieredKVStores end in (the
    cluster-wide disaggregated pool): promotion out of a shared tier
    COPIES the entry into the fetching hierarchy's hot tier instead of
    moving it — the pool copy must stay visible to every other worker.
    """

    def __init__(self, spec: TierSpec, block: int):
        self.spec = spec
        self.name = spec.name
        self.shared = False
        self.trace = (spec.bandwidth
                      if isinstance(spec.bandwidth, BandwidthTrace)
                      else BandwidthTrace.constant(float(spec.bandwidth)))
        self.wire = KVWire(self.trace)
        self.store = PrefixKVStore(int(spec.capacity_bytes), block=block)

    @property
    def fetch_overhead(self) -> float:
        return self.spec.fetch_overhead


@dataclass
class TierHit:
    """A lookup hit, tagged with the tier that holds the bytes."""

    entry: StoreEntry
    tier_index: int
    tier: KVTier


@dataclass
class TieredStats(StoreStats):
    promotions: int = 0       # entries copied up on access
    demotions: int = 0        # victims pushed down instead of dropped
    slo_protected: int = 0    # tier-level inserts demoted by the SLO rule
    tier_hits: Dict[str, int] = field(default_factory=dict)


def default_tier_specs(remote_capacity: int, remote_bandwidth: Any,
                       *, remote_overhead: float = 0.002,
                       hot_bytes: int = 4 << 20,
                       hot_bandwidth: float = 64e9,
                       dram_bytes: int = 16 << 20,
                       dram_bandwidth: float = 8e9,
                       dram_overhead: float = 5e-4,
                       dram_profile: Optional[Any] = None,
                       remote_profile: Optional[Any] = None
                       ) -> List[TierSpec]:
    """The canonical HBM -> DRAM -> remote-pool hierarchy."""
    return [
        TierSpec("hbm", int(hot_bytes), bandwidth=hot_bandwidth),
        TierSpec("dram", int(dram_bytes), bandwidth=dram_bandwidth,
                 fetch_overhead=dram_overhead, profile=dram_profile),
        TierSpec("remote", int(remote_capacity), bandwidth=remote_bandwidth,
                 fetch_overhead=remote_overhead, profile=remote_profile,
                 observe_goodput=True),
    ]


class TieredKVStore:
    """Ordered hierarchy of :class:`PrefixKVStore` tiers with serialized
    per-tier fetch links.

    Placement: ``put`` lands at the hottest tier that fits (``tier=`` picks
    the starting tier; the PD runtime writes straight to the pool tier);
    capacity pressure *demotes* victims down the hierarchy — re-compressed
    with the destination tier's profile via the owner-installed
    ``recompress(entry, profile) -> (payload, wire_bytes) | None`` hook —
    and only the last tier truly evicts.  A tier-level insert that would
    evict a strictly more critical SLO rank demotes the incoming entry
    instead (``stats.slo_protected``).  Hits promote to the hot tier on
    access (piggybacking on the fetch — no extra link time); demotion
    transfers ARE billed on the destination tier's link, and a demoted
    entry stays invisible until its transfer lands (``created`` rule).
    """

    def __init__(self, specs: Sequence[Any], block: int = 16,
                 estimator: Optional[Any] = None,
                 recompress: Optional[
                     Callable[[StoreEntry, Any],
                              Optional[Tuple[Any, int]]]] = None):
        assert specs, "at least one tier required"
        self.block = int(block)
        # A spec list may mix TierSpec (a private tier is built) with
        # pre-built KVTier objects (adopted as-is).  Sharing one KVTier
        # across several TieredKVStores is how a cluster models worker-
        # LOCAL hot tiers over a SHARED disaggregated remote pool: each
        # decode worker's hierarchy ends in the same pool tier, so its
        # capacity, entries and serialized link are cluster-global while
        # HBM/DRAM stay per-worker.
        self.tiers: List[KVTier] = [
            s if isinstance(s, KVTier) else KVTier(s, self.block)
            for s in specs]
        self.estimator = estimator
        self.recompress = recompress
        self.stats = TieredStats()

    # ------------------------------------------------------------------
    @classmethod
    def wrap_flat(cls, store: PrefixKVStore, bandwidth: Any,
                  fetch_overhead: float = 0.0,
                  estimator: Optional[Any] = None,
                  name: str = "remote") -> "TieredKVStore":
        """Adopt an existing flat pool as a single remote tier (the
        caller's store object keeps owning entries and stats)."""
        spec = TierSpec(name, store.capacity_bytes, bandwidth=bandwidth,
                        fetch_overhead=fetch_overhead, observe_goodput=True)
        self = cls([spec], block=store.block, estimator=estimator)
        self.tiers[0].store = store
        return self

    # ------------------------------------------------------------------
    def lookup(self, tokens: TokenKey, now: float = 0.0,
               full: bool = False) -> Optional[TierHit]:
        """Walk tiers hot -> cold; first tier holding a usable prefix wins
        (the hierarchy is exclusive: a key lives in exactly one tier)."""
        partial = False
        for i, tier in enumerate(self.tiers):
            before_pm = tier.store.stats.partial_misses
            e = tier.store.lookup(tokens, now=now, full=full)
            if e is not None:
                self.stats.hits += 1
                self.stats.tier_hits[tier.name] = \
                    self.stats.tier_hits.get(tier.name, 0) + 1
                return TierHit(entry=e, tier_index=i, tier=tier)
            partial = partial or (tier.store.stats.partial_misses > before_pm)
        if partial:
            self.stats.partial_misses += 1
        else:
            self.stats.misses += 1
        return None

    def contains(self, tokens: TokenKey, now: float = 0.0) -> bool:
        return any(t.store.contains(tokens, now=now) for t in self.tiers)

    def peek(self, tokens: TokenKey, now: float = 0.0) -> Optional[TierHit]:
        """Stats- and recency-NEUTRAL exact-key probe (the routing
        layer's view): which tier holds the prefix, and at how many wire
        bytes — without counting a hit, bumping recency, or promoting.
        Same write-visibility rule as :meth:`lookup`."""
        tokens = tuple(tokens)
        for i, tier in enumerate(self.tiers):
            e = tier.store._entries.get(tokens)
            if e is not None and e.created <= now:
                return TierHit(entry=e, tier_index=i, tier=tier)
        return None

    # ------------------------------------------------------------------
    def _maybe_recompress(self, entry: StoreEntry, tier: KVTier) -> None:
        prof = tier.spec.profile
        if prof is None or self.recompress is None:
            return
        out = self.recompress(entry, prof)
        if out is None:
            return
        payload, wire_bytes = out
        if int(wire_bytes) >= entry.wire_bytes:
            return  # demotion re-compression only ever shrinks
        entry.payload = payload
        entry.wire_bytes = int(wire_bytes)

    def _place(self, entry: StoreEntry, start: int, now: float,
               fresh: bool) -> Optional[int]:
        """Insert ``entry`` at the hottest tier >= ``start`` that accepts
        it, cascading victims downward.  Returns the tier index stored at,
        or None when the entry fell off the bottom (fresh put -> rejected;
        demoted victim -> true eviction)."""
        i, demoted = start, not fresh
        while i < len(self.tiers):
            tier = self.tiers[i]
            if demoted:
                self._maybe_recompress(entry, tier)
            status, evicted = tier.store.try_put_entry(entry)
            if status == "stored":
                if demoted:
                    # The demotion transfer occupies the destination link;
                    # the entry is invisible until its bytes land.
                    tr = tier.wire.send(now, entry.wire_bytes)
                    entry.created = entry.last_used = tr.end
                for v in evicted:
                    # A victim only counts as demoted if it actually lands
                    # somewhere below; falling off the bottom is an
                    # eviction (counted inside the recursive call).
                    if self._place(v, i + 1, now, fresh=False) is not None:
                        self.stats.demotions += 1
                return i
            if status == "protected":
                self.stats.slo_protected += 1
            i, demoted = i + 1, True
        if fresh:
            self.stats.rejected_puts += 1
        else:
            self.stats.evictions += 1
        return None

    # ------------------------------------------------------------------
    def put(self, tokens: TokenKey, payload: Any, wire_bytes: int,
            kv_bytes: float = 0.0, workload: str = "",
            slo_class: str = "standard", now: float = 0.0,
            tier: int = 0) -> Optional[int]:
        """Place a fresh entry starting at tier ``tier`` (no link billing —
        use :meth:`write` to also occupy the tier's wire).  Stale copies of
        the key anywhere in the hierarchy are dropped first — but a
        refresh whose placement is rejected everywhere restores the old
        copy (same rollback rule as the flat store).  A cluster-SHARED
        tier is never pre-clobbered: other workers' hierarchies end in
        it, so one worker's local refresh must not remove a copy the
        whole cluster relies on (a placement that cascades INTO the
        shared tier still same-key-replaces there).  Returns the tier
        index the entry landed at, or None if rejected."""
        tokens = tuple(tokens)
        old: Optional[Tuple[KVTier, StoreEntry]] = None
        for t in self.tiers:
            if t.shared:
                continue
            e = t.store.discard(tokens)
            if e is not None:
                old = (t, e)
        entry = StoreEntry(tokens=tokens, payload=payload,
                           wire_bytes=int(wire_bytes), kv_bytes=kv_bytes,
                           workload=workload, slo_class=slo_class,
                           created=now, last_used=now)
        placed = self._place(entry, min(tier, len(self.tiers) - 1), now,
                             fresh=True)
        if placed is None and old is not None:
            # A fully rejected placement mutates no tier store, so the old
            # copy's slot is still free: putting it back cannot fail.
            old[0].store.try_put_entry(old[1])
        return placed

    def write(self, tokens: TokenKey, payload: Any, wire_bytes: int,
              kv_bytes: float = 0.0, workload: str = "",
              slo_class: str = "standard", ready: float = 0.0,
              tier: int = 0) -> WireTransfer:
        """A pool write: the payload crosses the target tier's serialized
        link (contending with fetches), and the entry only becomes visible
        at the transfer's completion time."""
        ti = min(tier, len(self.tiers) - 1)
        t = self.tiers[ti]
        tr = t.wire.send(ready, wire_bytes)
        self._observe(t, wire_bytes, tr.t_comm)
        self.put(tokens, payload, wire_bytes, kv_bytes=kv_bytes,
                 workload=workload, slo_class=slo_class, now=tr.end,
                 tier=ti)
        return tr

    # ------------------------------------------------------------------
    def _observe(self, tier: KVTier, nbytes: float, seconds: float) -> None:
        # KVWire-attached estimators (the PD runtime shares its transfer
        # wire with the pool tier) already observed inside send().
        if (tier.spec.observe_goodput and self.estimator is not None
                and tier.wire.estimator is None):
            self.estimator.observe(nbytes, seconds)

    def fetch(self, hit: TierHit, ready: float,
              promote: bool = True) -> WireTransfer:
        """Pull a hit's bytes over its tier's serialized link (concurrent
        fetches queue).  The returned transfer is relative to
        ``ready + tier.fetch_overhead``; on success the entry is promoted
        to the hot tier (the bytes just crossed the link — the copy is
        free, and the entry stays visible from its original write)."""
        tier = hit.tier
        tr = tier.wire.send(ready + tier.fetch_overhead,
                            hit.entry.wire_bytes)
        self._observe(tier, hit.entry.wire_bytes, tr.t_comm)
        if promote:
            self._promote(hit, tr.end)
        return tr

    def _promote(self, hit: TierHit, now: float) -> None:
        if hit.tier_index == 0:
            return
        tier0 = self.tiers[0]
        if hit.entry.wire_bytes > tier0.store.capacity_bytes:
            return  # can never fit the hot tier: stay put
        if hit.tier.shared:
            # The holding tier is a cluster-SHARED pool: other workers'
            # hierarchies end in it, so promotion COPIES the entry into
            # this hierarchy's hot tier (the bytes just crossed the link;
            # the pool copy physically remains and must stay visible to
            # every other worker).  A distinct StoreEntry keeps the two
            # copies' recency/bytes accounting independent.
            from dataclasses import replace as _dc_replace
            e = _dc_replace(hit.entry, last_used=now)
            status, evicted = tier0.store.try_put_entry(e)
            if status != "stored":
                return
            hit.entry.last_used = now
        else:
            e = hit.tier.store.discard(hit.entry.tokens)
            if e is None:
                return
            # Promotion must never make an entry LESS visible: it has
            # been servable since its original `created` (the source copy
            # would physically remain until overwritten), so a concurrent
            # lookup at the same instant still hits.  Only recency moves.
            e.last_used = now
            status, evicted = tier0.store.try_put_entry(e)
            if status != "stored":
                hit.tier.store.try_put_entry(e)  # roll back where it lived
                return
        self.stats.promotions += 1
        for v in evicted:
            if self._place(v, 1, now, fresh=False) is not None:
                self.stats.demotions += 1

    def reencode(self, hit: TierHit, profile: Any) -> bool:
        """Re-compress a stored entry in place with ``profile`` (the
        controller's "refetch smaller" route) — capacity accounting on the
        holding tier follows the shrink."""
        if self.recompress is None:
            return False
        out = self.recompress(hit.entry, profile)
        if out is None:
            return False
        payload, wire_bytes = out
        if int(wire_bytes) >= hit.entry.wire_bytes:
            return False
        hit.tier.store.used_bytes -= hit.entry.wire_bytes - int(wire_bytes)
        hit.entry.payload = payload
        hit.entry.wire_bytes = int(wire_bytes)
        return True

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return sum(len(t.store) for t in self.tiers)

    @property
    def used_bytes(self) -> int:
        return sum(t.store.used_bytes for t in self.tiers)

    @property
    def capacity_bytes(self) -> int:
        return sum(t.store.capacity_bytes for t in self.tiers)

    @property
    def free_bytes(self) -> int:
        return self.capacity_bytes - self.used_bytes

    def entries(self) -> List[StoreEntry]:
        return [e for t in self.tiers for e in t.store.entries()]

    def summary(self) -> Dict[str, float]:
        out = {
            "entries": len(self),
            "used_bytes": self.used_bytes,
            "capacity_bytes": self.capacity_bytes,
            "hit_rate": self.stats.hit_rate,
            "hits": self.stats.hits,
            "misses": self.stats.misses,
            "partial_misses": self.stats.partial_misses,
            "evictions": self.stats.evictions,
            "rejected_puts": self.stats.rejected_puts,
            "promotions": self.stats.promotions,
            "demotions": self.stats.demotions,
            "slo_protected": self.stats.slo_protected,
        }
        for i, tier in enumerate(self.tiers):
            out[f"tier{i}_{tier.name}_entries"] = len(tier.store)
            out[f"tier{i}_{tier.name}_used_bytes"] = tier.store.used_bytes
            out[f"tier{i}_{tier.name}_hits"] = \
                self.stats.tier_hits.get(tier.name, 0)
        return out

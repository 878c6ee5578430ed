"""The analytical latency model (Sec. 3.2 / 6.1).

  T_p(c)  = T_model(w) + V/s_p + V/(B·cr_p)          (Eq. 1)
  T_0(c)  = T_model(w) + V/B
  B*_p    = (1 - 1/cr_p) · s_p                        (Eq. 5, Theorem 6.1)
  T̃_p(x) = 1/s_p + x/cr_p,  x = 1/B                  (Eq. 6)

Profiles are beneficial iff B < B*_p — independent of V.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.profiles import Profile


@dataclass(frozen=True)
class ServiceContext:
    """c = (w, B, T_SLO, q_min) — Sec. 3.1."""

    workload: str
    bandwidth: float        # effective bytes/s (network or IO goodput)
    t_slo: float            # seconds
    q_min: float            # minimum relative quality
    t_model: float = 0.0    # strategy-independent execution time
    kv_bytes: float = 0.0   # V — uncompressed KV payload of the segment
    # Which latency t_slo bounds ("ttft" | "jct").  The runtime feeds the
    # matching observation through ServiceAwareController.observe, so the
    # bandit's violation cooldown fires on the same metric the serving
    # layer reports as slo_violated.
    slo_metric: str = "jct"
    # Placement route identity ("p0->d1") in a multi-worker cluster: the
    # controller keeps a separate residual bandit per route, so the
    # offline->online drift of EACH link is learned independently (a
    # congested 50 Mbps cross-rack wire and an idle 1 Gbps local link get
    # different residual corrections).  "" = single-link / routeless.
    route: str = ""
    # Decode side runs a paged arena with fused dequant-attention
    # (DESIGN.md §12): paged-eligible profiles skip the materialized
    # decompress, so Eq. 1's s_eff term keeps only its encode half.
    fused_dec: bool = False
    # Strategy-independent serial decode-stream time (out_tokens at the
    # decode worker's per-token rate).  Speculative decoding divides it
    # by the expected committed tokens per verify step (DESIGN.md §15);
    # 0.0 when unknown (the k-selection then ranks on throughput alone).
    decode_time: float = 0.0


def predicted_latency(p: Profile, c: ServiceContext) -> float:
    """T_p(c) per Eq. 1.  Under a fused-dequant decode arena
    (``c.fused_dec``) a paged-eligible profile pays only the encode side
    of the codec: V/s_enc instead of V/s_eff."""
    from repro_torch.core.strategy import paged_eligible

    v = c.kv_bytes
    if c.fused_dec and paged_eligible(p.strategy):
        s_term = 0.0 if p.s_enc == float("inf") else v / p.s_enc
    else:
        s_term = 0.0 if p.s_eff == float("inf") else v / p.s_eff
    return c.t_model + s_term + v / (c.bandwidth * p.cr)


def baseline_latency(c: ServiceContext) -> float:
    return c.t_model + c.kv_bytes / c.bandwidth


def bandwidth_threshold(p: Profile) -> float:
    """B*_p (Theorem 6.1): beneficial iff B < B*_p."""
    if p.cr <= 1.0:
        return 0.0
    if p.s_eff == float("inf"):
        return float("inf")
    return (1.0 - 1.0 / p.cr) * p.s_eff


def is_beneficial(p: Profile, bandwidth: float) -> bool:
    return bandwidth < bandwidth_threshold(p)


def normalized_latency(p: Profile, inv_bandwidth: float) -> float:
    """T̃_p(x) = 1/s_p + x/cr_p (Eq. 6)."""
    s_term = 0.0 if p.s_eff == float("inf") else 1.0 / p.s_eff
    return s_term + inv_bandwidth / p.cr


# ---------------------------------------------------------------------------
# Speculative-decode terms (DESIGN.md §15): the decode-stream analogue of
# Eq. 1's transfer terms.  With draft budget k and per-draft acceptance
# rate r, a greedy verify step commits 1 bonus token plus a geometric
# accepted prefix.
# ---------------------------------------------------------------------------
def expected_tokens_per_step(k: int, accept_rate: float) -> float:
    """E[committed tokens per verify step] = sum_{j=0..k} r^j — one bonus
    token always commits; draft j commits iff all drafts before it did
    (i.i.d. per-draft acceptance r).  k = 0 gives exactly 1.0, the plain
    one-token decode."""
    r = min(max(accept_rate, 0.0), 1.0)
    return sum(r ** j for j in range(max(k, 0) + 1))


def speculative_decode_latency(decode_time: float, k: int,
                               accept_rate: float,
                               verify_overhead: float = 0.0) -> float:
    """Decode-stream time with k-draft speculation: the serial decode
    time shrinks by the expected committed tokens per verify step, while
    each (wider) verify step may carry a relative overhead
    ``verify_overhead`` per draft slot.  Monotone pieces pull against
    each other, so argmin over a candidate set is the k-selection rule
    (the controller breaks latency ties toward smaller k — at
    accept_rate 0 every k collapses to the baseline and k = 0 wins)."""
    tps = expected_tokens_per_step(k, accept_rate)
    return decode_time * (1.0 + verify_overhead * max(k, 0)) / tps


# ---------------------------------------------------------------------------
# Tier-aware fetch term (ISSUE 4): the KV prefix lives in a memory
# hierarchy, so the cost of materializing it depends on WHERE the bytes
# sit and on which encoding crosses that tier's link.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TierFetch:
    """One route for materializing a stored KV prefix.

    ``variant="stored"`` fetches the tier's stored encoding as-is;
    ``variant="reencoded"`` pays a source-side re-encode (``s_enc``) to
    cross the link with fewer bytes — the "refetch smaller" route that
    wins on slow links."""

    tier: str                     # holding tier ("hbm" | "dram" | "remote")
    wire_bytes: float             # bytes that cross the tier's fetch link
    kv_bytes: float               # uncompressed payload V (decode restore)
    bandwidth: float              # tier link effective bytes/s
    overhead: float = 0.0         # per-fetch RPC/setup cost
    s_dec: float = float("inf")   # decode-side decompress throughput
    s_enc: float = float("inf")   # source-side re-encode throughput
    variant: str = "stored"
    # The fetched encoding lands as packed quantized pages consumed by
    # the fused dequant-attention decode (DESIGN.md §12) — no
    # materialized decompress term.
    fused_dequant: bool = False


def tier_fetch_latency(opt: TierFetch) -> float:
    """T_fetch = o + V/s_enc + wire/B_tier + V/s_dec — the tier-aware
    analogue of Eq. 1's transfer term.  ``fused_dequant`` drops the
    V/s_dec term: the pages decode in place."""
    enc = 0.0 if opt.s_enc == float("inf") else opt.kv_bytes / opt.s_enc
    dec = (0.0 if opt.fused_dequant or opt.s_dec == float("inf")
           else opt.kv_bytes / opt.s_dec)
    return (opt.overhead + enc + opt.wire_bytes / max(opt.bandwidth, 1e-9)
            + dec)

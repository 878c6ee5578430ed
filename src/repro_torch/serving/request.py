"""Request / session model for the disaggregated serving runtime."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.data.synthetic import WORKLOADS

# Explicit request lifecycle (PD-disaggregated continuous runtime): the
# scheduler moves a request waiting -> prefilling; the engine advances it
# prefilling -> transferring (its compressed KV is on the wire) ->
# decoding -> done.  Pool hits skip prefilling (the pool fetch IS their
# transfer).  "rejected" is terminal for load-shed requests.
LIFECYCLE = ("waiting", "prefilling", "transferring", "decoding", "done",
             "rejected")


@dataclass(slots=True)
class Request:
    rid: int
    workload: str            # router-provided label w (Sec. 2.2)
    arrival: float           # seconds
    ctx_tokens: int          # prompt length
    out_tokens: int          # decode length
    kv_bytes: float          # uncompressed KV payload V
    t_slo: float = 0.0       # 0 = no SLO
    # Which latency the SLO (and the controller's guardrail feedback)
    # targets: "ttft" | "jct".  None = the serving scenario's default
    # (pool/prefix-caching -> ttft, PD separation -> jct), resolved by
    # whichever backend executes the request.
    slo_metric: Optional[str] = None
    q_min: float = 0.97
    prefix_hit: bool = False  # pool scenario: reusable KV exists remotely
    # Scheduler priority class: interactive | standard | batch
    # (see repro.serving.kvstore.SLO_CLASSES).
    slo_class: str = "standard"
    # Token prefix identifying reusable KV in a PrefixKVStore; when set, the
    # store (not the prefix_hit flag) decides pool hits.
    prefix_key: Optional[Tuple[int, ...]] = None

    # Arena slot id while in flight (assigned by ContinuousScheduler on
    # admission to a running slot, released on finish; None while waiting
    # and in the event-driven simulator, which has no physical slots).
    slot: Optional[int] = None
    # Lifecycle state (see LIFECYCLE); maintained by the scheduler and the
    # continuous runtime, observational for the event-driven simulator.
    state: str = "waiting"

    def resolved_slo_metric(self, scenario_default: str = "jct") -> str:
        return self.slo_metric if self.slo_metric is not None \
            else scenario_default

    # ---- outcome fields (filled by the simulator) ----
    done: float = 0.0
    ttft: float = 0.0
    breakdown: Dict[str, float] = field(default_factory=dict)
    chosen: str = ""
    # Placement route ("p0->d1") when a NetworkTopology routed the request
    # (multi-worker cluster / topology-driven simulator); "" otherwise.
    route: str = ""
    slo_violated: bool = False
    retries: int = 0

    @property
    def jct(self) -> float:
        return self.done - self.arrival


def kv_bytes_for(ctx_tokens: int, num_layers: int, kv_heads: int,
                 head_dim: int, bytes_per_el: int = 2) -> float:
    return 2.0 * num_layers * kv_heads * head_dim * ctx_tokens * bytes_per_el


@dataclass
class WorkloadMix:
    """Poisson arrivals over a workload mix."""

    rate: float = 4.0                      # requests/s
    mix: Optional[Dict[str, float]] = None
    ctx_scale: float = 1.0
    seed: int = 0
    model_layers: int = 32
    model_kv_heads: int = 8
    model_head_dim: int = 128
    slo: float = 0.0
    q_min: float = 0.97
    prefix_hit_rate: float = 0.0
    # Share of each SLO class, e.g. {"interactive": 0.3, "batch": 0.7}.
    slo_class_mix: Optional[Dict[str, float]] = None

    def generate(self, n: int):
        rng = np.random.default_rng(self.seed)
        # The new draws (prefix-pool reuse, SLO class) come from a second
        # generator so the primary stream — and therefore every previously
        # seeded workload (arrivals, ctx/out lengths, prefix_hit flags) —
        # is byte-identical to what it produced before these fields existed.
        rng_aux = np.random.default_rng((self.seed, 0x9E3779B9))
        mix = self.mix or {w: 1.0 for w in WORKLOADS}
        names = list(mix)
        probs = np.asarray([mix[w] for w in names], dtype=float)
        probs /= probs.sum()
        classes, class_probs = ["standard"], np.asarray([1.0])
        if self.slo_class_mix:
            classes = list(self.slo_class_mix)
            class_probs = np.asarray([self.slo_class_mix[c] for c in classes],
                                     dtype=float)
            class_probs /= class_probs.sum()
        # Per-workload pool of previously issued prefixes: with probability
        # prefix_hit_rate a request re-uses one (so a PrefixKVStore sees a
        # genuine share-able prefix population; the first user of a prefix
        # still pays the cold miss).
        prefix_pools: Dict[str, list] = {w: [] for w in names}
        t = 0.0
        out = []
        for i in range(n):
            t += rng.exponential(1.0 / self.rate)
            w = names[int(rng.choice(len(names), p=probs))]
            spec = WORKLOADS[w]
            ctx = int(max(64, rng.lognormal(
                np.log(spec.ctx_scale * self.ctx_scale * 16), 0.4)))
            gen = int(max(4, rng.poisson(spec.out_scale * 4)))
            pool = prefix_pools[w]
            if pool and rng_aux.random() < self.prefix_hit_rate:
                key = pool[int(rng_aux.integers(len(pool)))]
            else:
                key = (i,)
                pool.append(key)
            out.append(Request(
                rid=i, workload=w, arrival=t, ctx_tokens=ctx, out_tokens=gen,
                kv_bytes=kv_bytes_for(ctx, self.model_layers,
                                      self.model_kv_heads, self.model_head_dim),
                t_slo=self.slo, q_min=self.q_min,
                prefix_hit=bool(rng.random() < self.prefix_hit_rate),
                slo_class=classes[int(rng_aux.choice(len(classes),
                                                     p=class_probs))],
                prefix_key=key,
            ))
        return out

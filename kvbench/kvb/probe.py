"""Spans, counters and captures taken from the benchmark's own wrappers
around the calls into each layer of the port.  Installing patches the
port's classes in this process only; ``uninstall`` puts them back.

Spans are host wall-clock intervals (``time.perf_counter``) of calls
that end on a device synchronise (a prefill, the compress stage, a
decode iteration, which pulls its tokens).  Counters are the work each
call was given, read from host state only, so that counting adds no
synchronise to the timed path."""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

from kvb import counts


@dataclass
class Landed:
    """What one request's start left for the check and the metrics."""

    rid: int
    profile: Any = None           # the controller's Profile
    payload: Any = None           # the wire payload (kept for candidates)
    arena: Any = None             # first layer's cache parts as landed in
                                  # the decode arena (candidates)
    own_bytes: Optional[int] = None   # the harness's count of the payload
    sent: List[float] = field(default_factory=list)   # KVWire.send bytes
    prompt: Any = None            # the prompt ids the prefill was given


class Probe:
    def __init__(self, cfg: Dict, model, candidates: Set[int] = frozenset()):
        self.model = model                  # the configuration's module
        self.sizes = model.sizes(cfg)
        self.candidates = set(candidates)   # rids whose payload is kept
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.landed: Dict[int, Landed] = {}
        self.decode_flops = 0.0
        self.decode_tokens = 0
        self.prefill_flops = 0.0
        self.profiling = False      # inside the traced sub-window
        self.traced_bytes: Dict[str, float] = defaultdict(float)
        self.traced_calls: Dict[str, int] = defaultdict(int)
        self.host_spans: List[tuple] = []   # (name, t0, t1) while profiling
        self._current: Optional[int] = None
        self._saved: List[tuple] = []

    # ------------------------------------------------------------------
    def _span(self, name: str, t0: float, t1: float) -> None:
        self.spans[name].append(t1 - t0)
        if self.profiling:
            self.host_spans.append((name, t0, t1))

    def _patch(self, owner, attr: str, make) -> None:
        real = getattr(owner, attr)
        self._saved.append((owner, attr, real))
        setattr(owner, attr, make(real))

    def install(self) -> None:
        import repro_torch.kernels as kernels
        from repro_torch.serving import cluster, network, workers

        probe = self

        def start(real):
            def wrapped(rt, req, route, now, busy):
                probe._current = req.rid
                probe.landed.setdefault(req.rid, Landed(req.rid))
                t0 = time.perf_counter()
                try:
                    return real(rt, req, route, now, busy)
                finally:
                    probe._span("start", t0, time.perf_counter())
                    probe._current = None
            return wrapped

        def prefill(real):
            def wrapped(pw, req, tokens):
                t0 = time.perf_counter()
                out = real(pw, req, tokens)
                probe._span("prefill", t0, time.perf_counter())
                probe.prefill_flops += counts.prefill_flops(
                    probe.sizes, len(tokens))
                land = probe.landed.setdefault(req.rid, Landed(req.rid))
                if req.rid in probe.candidates:
                    land.prompt = list(int(t) for t in tokens)
                return out
            return wrapped

        def compress(real):
            def wrapped(pw, req, *args, **kw):
                t0 = time.perf_counter()
                out = real(pw, req, *args, **kw)
                probe._span("compress", t0, time.perf_counter())
                comp, _, _, profile, _ = out
                land = probe.landed.setdefault(req.rid, Landed(req.rid))
                land.profile = profile
                land.own_bytes = probe.model.payload_bytes(comp)
                if req.rid in probe.candidates:
                    land.payload = comp
                return out
            return wrapped

        def inject(real):
            def wrapped(dw, kv, idx):
                out = real(dw, kv, idx)
                rid = probe._current
                if rid in probe.candidates and dw.cfg.paged:
                    probe.landed[rid].arena = probe.model.landed_parts(
                        dw, idx, int(kv.seq))
                return out
            return wrapped

        def send(real):
            def wrapped(wire, ready, nbytes):
                if probe._current is not None:
                    probe.landed[probe._current].sent.append(float(nbytes))
                return real(wire, ready, nbytes)
            return wrapped

        def decompress(real):
            def wrapped(*args, **kw):
                t0 = time.perf_counter()
                out = real(*args, **kw)
                probe._span("decompress", t0, time.perf_counter())
                return out
            return wrapped

        def decode(real):
            def wrapped(dw, active):
                ctx = [int(dw._positions[s.idx]) for s in active]
                qlen = [int(dw._quant_len[s.idx]) for s in active]
                t0 = time.perf_counter()
                out = real(dw, active)
                probe._span("decode_iteration", t0, time.perf_counter())
                probe.decode_flops += counts.decode_step_flops(
                    probe.sizes, [c + 1 for c in ctx])
                probe.decode_tokens += len(active)
                if probe.profiling and dw.cfg.paged:
                    probe.traced_bytes["paged_attention"] += \
                        counts.paged_attention_bytes(
                            probe.sizes, ctx, qlen, dw.n_slots, dw._pps,
                            dw.cfg.page_size)
                    probe.traced_calls["paged_attention"] += \
                        probe.sizes["attn_layers"]
                return out
            return wrapped

        def quant_pack(real):
            def wrapped(x, bits=8, group=64, **kw):
                if probe.profiling:
                    probe.traced_bytes["quant_pack"] += \
                        counts.quant_pack_bytes(x.shape[0], x.shape[1], bits,
                                                group, x.element_size())
                    probe.traced_calls["quant_pack"] += 1
                return real(x, bits=bits, group=group, **kw)
            return wrapped

        self._patch(cluster.ClusterRuntime, "_start_request_pd", start)
        self._patch(cluster.ClusterRuntime, "_start_request", start)
        self._patch(workers.PrefillWorker, "prefill", prefill)
        self._patch(workers.PrefillWorker, "select_and_compress", compress)
        self._patch(workers.DecodeWorker, "inject_restored", inject)
        self._patch(network.KVWire, "send", send)
        self._patch(cluster, "decompress_kvs", decompress)
        self._patch(workers.DecodeWorker, "decode_iteration", decode)
        self._patch(kernels, "quant_pack_op", quant_pack)

    def uninstall(self) -> None:
        while self._saved:
            owner, attr, real = self._saved.pop()
            setattr(owner, attr, real)

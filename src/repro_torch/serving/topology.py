"""Cluster network topology: one serialized KV wire per (src, dst) pair.

A PD-separated cluster is not a single link: every (prefill worker ->
decode worker) pair owns its own physical path, with its own —
possibly heterogeneous — bandwidth profile, its own serialized transfer
queue (:class:`~repro.serving.network.KVWire`), and its own
:class:`~repro.serving.network.GoodputEstimator` (the controller's
per-link view of B, seeded from the link's configured trace).  Transfers
on DIFFERENT links overlap freely; transfers on the SAME link contend —
which is exactly the structure load-aware routing exploits.

Build a homogeneous cluster with :meth:`NetworkTopology.full_mesh`, or a
heterogeneous one by overriding individual links::

    topo = NetworkTopology.full_mesh(
        1, 2, BandwidthTrace.constant(1 * GBPS),
        links={(0, 1): BandwidthTrace.constant(0.05 * GBPS)})

The same topology object drives the real-execution
:class:`~repro.serving.cluster.ClusterRuntime` and the event-driven
:class:`~repro.serving.simulator.Simulator` (large-scale sweeps), so
routing policies can be studied at both granularities against identical
link state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.serving.network import BandwidthTrace, GoodputEstimator, KVWire


def route_name(src: int, dst: int) -> str:
    """Canonical identity of the (prefill ``src`` -> decode ``dst``)
    placement route — also the controller's per-route bandit key."""
    return f"p{src}->d{dst}"


@dataclass
class LinkSpec:
    """Declarative description of one directed (src, dst) link."""

    src: int
    dst: int
    trace: BandwidthTrace


class NetworkTopology:
    """Per-(src, dst) serialized KV links of an N x M cluster."""

    def __init__(self, n_prefill: int = 1, n_decode: int = 1,
                 default_trace: Optional[BandwidthTrace] = None,
                 links: Optional[Dict[Tuple[int, int],
                                      BandwidthTrace]] = None):
        assert n_prefill >= 1 and n_decode >= 1
        self.n_prefill = n_prefill
        self.n_decode = n_decode
        default = default_trace or BandwidthTrace.constant(1e9)
        overrides = dict(links or {})
        for (i, j) in overrides:
            if not (0 <= i < n_prefill and 0 <= j < n_decode):
                raise ValueError(f"link ({i},{j}) outside the "
                                 f"{n_prefill}x{n_decode} mesh")
        self._traces: Dict[Tuple[int, int], BandwidthTrace] = {}
        self._wires: Dict[Tuple[int, int], KVWire] = {}
        for i in range(n_prefill):
            for j in range(n_decode):
                trace = overrides.get((i, j), default)
                self._traces[(i, j)] = trace
                # Each link's estimator starts from the link's OWN
                # configured bandwidth (KVWire seeds it), so routing can
                # tell a 50 Mbps wire from a 1 Gbps one before the first
                # transfer ever lands.
                self._wires[(i, j)] = KVWire(trace, GoodputEstimator())

    # ------------------------------------------------------------------
    @classmethod
    def full_mesh(cls, n_prefill: int, n_decode: int,
                  trace: BandwidthTrace,
                  links: Optional[Dict[Tuple[int, int],
                                       BandwidthTrace]] = None
                  ) -> "NetworkTopology":
        """Every (src, dst) pair connected at ``trace``; individual pairs
        may be overridden via ``links`` (heterogeneous meshes)."""
        return cls(n_prefill, n_decode, default_trace=trace, links=links)

    @classmethod
    def from_specs(cls, n_prefill: int, n_decode: int,
                   specs: List[LinkSpec],
                   default_trace: Optional[BandwidthTrace] = None
                   ) -> "NetworkTopology":
        return cls(n_prefill, n_decode, default_trace=default_trace,
                   links={(s.src, s.dst): s.trace for s in specs})

    # ------------------------------------------------------------------
    def link(self, src: int, dst: int) -> KVWire:
        return self._wires[(src, dst)]

    def trace(self, src: int, dst: int) -> BandwidthTrace:
        return self._traces[(src, dst)]

    def estimator(self, src: int, dst: int) -> GoodputEstimator:
        return self._wires[(src, dst)].estimator

    def pairs(self) -> Iterator[Tuple[int, int]]:
        """All (src, dst) pairs, prefill-major — the round-robin cycle
        order."""
        for i in range(self.n_prefill):
            for j in range(self.n_decode):
                yield (i, j)

    # ------------------------------------------------------------------
    @property
    def n_links(self) -> int:
        return self.n_prefill * self.n_decode

    @property
    def transfers(self) -> int:
        return sum(w.transfers for w in self._wires.values())

    @property
    def bytes_moved(self) -> int:
        return sum(w.bytes_moved for w in self._wires.values())

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {"links": float(self.n_links),
                                 "transfers": float(self.transfers),
                                 "bytes_moved": float(self.bytes_moved)}
        for (i, j), wire in sorted(self._wires.items()):
            out[f"link_{route_name(i, j)}_transfers"] = float(wire.transfers)
            out[f"link_{route_name(i, j)}_bytes"] = float(wire.bytes_moved)
        return out

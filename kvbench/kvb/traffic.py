"""The one traffic generator: reads a mix's data file and makes its
requests.

The schedule is the cell's, the same for every seed: within each block
of ``BLOCK`` requests the output lengths are the block's quantiles of the
mix's distribution and the arrival gaps the quantiles of the exponential
at the cell's rate, each block in an order drawn once from a fixed key;
workload kinds go round in blocks the same way.  The arrivals are thus
stratified, not Poisson draws: every block holds the same gaps, so the
count due in a window and the bursts within it do not vary.  The seed
draws what the requests say: their prompts, distinct per request.  Runs
on different seeds then carry the same work at the same times, and
differ in the prompts and the weights."""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np

BLOCK = 16


@dataclass(frozen=True)
class Req:
    index: int
    due: Optional[float]      # seconds after the window opens; None: closed loop
    workload: str
    prompt_seed: int
    out_tokens: int


def _quantiles(spec: Dict, n: int) -> np.ndarray:
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    u = (np.arange(n) + 0.5) / n
    z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
    vals = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.rint(vals), spec["min"], spec["max"]).astype(int)


class Traffic:
    """Requests of one cell and seed, by index."""

    def __init__(self, traffic: Dict, cell: Dict, seed: int):
        self.spec = traffic
        self.seed = int(seed)
        self.closed = traffic["arrivals"] == "closed"
        if traffic["arrivals"] not in ("stratified", "closed"):
            raise ValueError(f"unknown arrivals {traffic['arrivals']!r}")
        self.rate = None if self.closed else float(cell["rate_per_s"])
        self.clients = int(traffic["clients"]) if self.closed else 0
        self.workloads: List[str] = list(traffic["workloads"])
        self._lengths = _quantiles(traffic["out_tokens"], BLOCK)
        u = (np.arange(BLOCK) + 0.5) / BLOCK
        self._gaps = (-np.log1p(-u) / self.rate) if self.rate else None
        self._blocks: Dict[int, tuple] = {}
        self._due: List[float] = []

    def _key(self) -> List[int]:
        return [self.seed & 0xFFFFFFFF, (self.seed >> 32) & 0xFFFFFFFF]

    @staticmethod
    def _schedule(*key: int) -> np.random.Generator:
        """The cell's fixed schedule (no seed in the key)."""
        return np.random.default_rng([0x6B76, *key])

    def _block(self, b: int):
        got = self._blocks.get(b)
        if got is None:
            rng = self._schedule(1, b)
            gaps = (rng.permutation(self._gaps) if self._gaps is not None
                    else None)
            lengths = rng.permutation(self._lengths)
            got = (gaps, lengths)
            self._blocks[b] = got
        return got

    def _prompt_seed(self, i: int) -> int:
        return int(np.random.SeedSequence(
            [*self._key(), 2, i]).generate_state(1)[0])

    def _workload(self, i: int) -> str:
        n = len(self.workloads)
        order = self._schedule(5, i // n).permutation(n)
        return self.workloads[int(order[i % n])]

    def due(self, i: int) -> Optional[float]:
        if self.closed:
            return None
        while len(self._due) <= i:
            j = len(self._due)
            gap = self._block(j // BLOCK)[0][j % BLOCK]
            self._due.append((self._due[-1] if self._due else 0.0)
                             + float(gap))
        return self._due[i]

    def request(self, i: int) -> Req:
        lengths = self._block(i // BLOCK)[1]
        return Req(index=i, due=self.due(i), workload=self._workload(i),
                   prompt_seed=self._prompt_seed(i),
                   out_tokens=int(lengths[i % BLOCK]))

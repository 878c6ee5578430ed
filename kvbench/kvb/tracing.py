"""What the traced sub-window of a ``--trace 1`` run yields: kernel time
by name, device busy time and idle gaps named by what the host was doing
(``kvb.spans.ProgramTrace`` takes and reads the trace)."""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"


def short_name(name: str) -> str:
    """A kernel's name without its namespace, template and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"<.*", "", name.split("(")[0])
    return name.split("::")[-1].split()[-1] if name.strip() else name


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)
    n_events: int = 0

    def kernel_time(self, *names: str) -> float:
        return sum(t for k, t in self.kernel_s.items()
                   if any(n in k for n in names))

    def device_ops(self, n: int = 10) -> List[List]:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for label, dt in self.gaps:
            by[label] += dt
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v] for k, v in top]

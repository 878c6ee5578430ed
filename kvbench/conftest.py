"""The benchmark's own tests: the harness, the yardstick and the plain
reference on the CPU at a tiny size.  ``gpu`` tests run a real cell and
skip where no CUDA device is present."""
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
for p in (HERE, HERE.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# The tiny cells' windows are seconds of wall clock: one thread keeps a
# tiny model's steps from waiting on a busy host's other cores.
torch.set_num_threads(1)

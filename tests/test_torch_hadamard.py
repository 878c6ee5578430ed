"""The structure of the Hadamard table that ``csrc/hadamard.cu`` relies on.

The kernel reads no table: it takes c = H[0][0] of the host's f32 table
(``transforms.hadamard_matrix``, which the host pipeline multiplies by)
and gives entry (k, j) the sign (-1) ** popcount(k & j), split per block
of 8 (4 at D = 4) rows and columns as parity(k0 & j0) ^ parity(u & t).
Since fma(-x, c, a) == fma(x, -c, a) bit for bit, the kernel's in-order
FMA chains then equal numpy's ``x @ h`` on the host only if every entry
of the f32 table is exactly +c or -c.  These tests pin that on the CPU;
``test_torch_gpu.py::test_hadamard`` holds the kernel's bits on the card.
"""
import numpy as np
import pytest

from repro_torch.core.transforms import hadamard_matrix
from repro_torch.kernels import ref as R

DIMS = [4, 8, 16, 32, 64, 128, 256, 512]


def _parity(v: np.ndarray) -> np.ndarray:
    return np.array([bin(int(x)).count("1") & 1 for x in v.ravel()],
                    dtype=np.int64).reshape(v.shape)


@pytest.mark.parametrize("d", DIMS)
def test_table_entries_are_plus_or_minus_c(d):
    h = hadamard_matrix(d)
    c = h[0][0]
    assert c == R.hadamard_entry(d)
    k, j = np.meshgrid(np.arange(d), np.arange(d), indexing="ij")
    signs = 1 - 2 * _parity(k & j)
    want = (signs * c).astype(np.float32)          # +-c, exact in f32
    np.testing.assert_array_equal(h.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("block", [4, 8])
def test_sign_splits_per_block(block):
    """parity((k0 + u) & (j0 + t)) = parity(k0 & j0) ^ parity(u & t) for
    k0, j0 multiples of the block and u, t below it: the first factor
    flips c once per block of k-steps, the second is a constant negation
    of x in the kernel's unrolled FMAs."""
    k, j = np.meshgrid(np.arange(512), np.arange(512), indexing="ij")
    k0, u = k - k % block, k % block
    j0, t = j - j % block, j % block
    np.testing.assert_array_equal(_parity(k & j),
                                  _parity(k0 & j0) ^ _parity(u & t))

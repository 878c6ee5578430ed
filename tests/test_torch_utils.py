"""The port's small utilities (repro_torch.utils.timing / trees) against the
JAX package's: ``Timer``, ``timed``, and ``tree_size`` / ``tree_bytes``
equal to JAX's on the same trees."""
import time

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.utils.trees import tree_bytes as jax_tree_bytes  # noqa: E402
from repro.utils.trees import tree_size as jax_tree_size  # noqa: E402
from repro_torch.utils.timing import Timer, timed  # noqa: E402
from repro_torch.utils.trees import tree_bytes, tree_size  # noqa: E402


def test_timer_accumulates():
    t = Timer()
    assert t.mean == 0.0 and t.count == 0
    t.start()
    time.sleep(0.01)
    dt = t.stop()
    assert dt >= 0.009 and t.total == dt and t.count == 1
    t.start()
    t.stop()
    assert t.count == 2 and t.mean == pytest.approx(t.total / 2)


def test_timed_stops_on_error():
    t = Timer()
    with timed(t) as same:
        assert same is t
    with pytest.raises(ValueError):
        with timed(t):
            raise ValueError
    assert t.count == 2


TREES = {
    "nested": lambda lib: {"a": lib.zeros((3, 4), "float32"),
                           "b": {"c": lib.zeros((5,), "bfloat16"),
                                 "d": lib.zeros((2, 2, 2), "int8")}},
    "list": lambda lib: [lib.zeros((7,), "float32"),
                         {"x": lib.zeros((1, 9), "int32")}],
    "scalar_and_none": lambda lib: {"s": lib.zeros((), "float32"),
                                    "n": None},
    "empty": lambda lib: {"p": {}, "q": []},
}


class _Torch:
    @staticmethod
    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=getattr(torch, dtype))


class _Jax:
    @staticmethod
    def zeros(shape, dtype):
        return jnp.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("name", sorted(TREES))
def test_tree_sizes_equal_jax(name):
    port, ref = TREES[name](_Torch), TREES[name](_Jax)
    assert tree_size(port) == jax_tree_size(ref)
    assert tree_bytes(port) == jax_tree_bytes(ref)


def test_tree_bytes_numpy_leaves():
    tree = {"a": np.zeros((4, 4), np.float64), "b": np.zeros(3, np.int16)}
    assert tree_bytes(tree) == jax_tree_bytes(tree) == 4 * 4 * 8 + 3 * 2
    assert tree_size(tree) == jax_tree_size(tree) == 19

"""The port's op counter (repro_torch.launch.op_cost) against hand counts:
the counterparts of ``tests/test_hlo_cost.py`` and
``tests/test_hlo_cost_dus.py``, plus per-device counts on a fake mesh.

Everything runs on meta tensors (shapes only).  The fake 8-rank group is
PyTorch's own (``launch/mesh.py::init_fake_world``), started for this
module and torn down after it.
"""
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard, distribute_tensor  # noqa: E402

from repro_torch.launch.mesh import init_fake_world, make_test_mesh  # noqa: E402
from repro_torch.launch.op_cost import count_ops  # noqa: E402
from repro_torch.models.ssm import _causal_depthwise_conv  # noqa: E402


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_matmul_exact():
    m = 256
    a, b = meta(m, m), meta(m, m)
    _, c = count_ops(lambda: a @ b)
    assert c.flops == 2 * m ** 3
    assert c.bytes == 3 * m * m * 4


def test_stacked_blocks_multiply_by_count():
    m, n = 128, 10

    def stack(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    x, ws = meta(m, m), meta(n, m, m)
    _, one = count_ops(stack, x, ws[:1])
    _, all_ = count_ops(stack, x, ws)
    assert all_.flops == n * one.flops
    assert all_.bytes == n * one.bytes
    assert one.flops == 2 * m ** 3 + m * m          # the product and tanh


def test_nested_loops():
    m = 64

    def g(x, ws):
        for w3 in ws:
            for w in w3:
                x = x @ w
        return x

    _, c = count_ops(g, meta(m, m), meta(4, 3, m, m))
    assert c.flops == 12 * 2 * m ** 3


def test_bf16_matmul():
    m = 128
    a, b = meta(m, m, dtype=torch.bfloat16), meta(m, m, dtype=torch.bfloat16)
    _, c = count_ops(lambda: a @ b)
    assert c.flops == 2 * m ** 3
    assert c.bytes == 3 * m * m * 2


def test_mamba_depthwise_conv_right_order():
    # the mamba front end's causal depthwise conv: k taps per output
    b, ch, s, k = 2, 16, 64, 4
    _, c = count_ops(_causal_depthwise_conv, meta(b, s, ch), meta(ch, k),
                     meta(ch))
    out_elems = b * ch * s
    expected = 2 * out_elems * k
    assert out_elems <= c.flops <= 2 * expected


def test_no_collectives_on_one_device():
    m = 64
    _, c = count_ops(lambda a, b: a @ b, meta(m, m), meta(m, m))
    assert c.coll_bytes == 0.0 and not c.coll_breakdown


def test_loop_writing_rows_costs_linear():
    """(D,) rows written into an (N, D) buffer one by one cost O(N·D)
    bytes in all, not O(N²·D) (the scan-ys case of the JAX walker)."""
    n, d = 256, 512

    def f(x):
        buf = torch.empty((n, d), device="meta")
        for i in range(n):
            x = torch.tanh(x)
            buf[i] = x
        return buf

    _, c = count_ops(f, meta(d))
    linear = n * d * 4
    assert c.bytes == 4 * linear   # tanh read + write, the row's copy r + w
    assert c.bytes < 20 * linear


def test_index_put_charged_update_region():
    big, upd = 1 << 20, 128
    buf = meta(big)
    idx = torch.empty(upd, dtype=torch.int64, device="meta")
    _, c = count_ops(lambda: buf.index_put_((idx,), meta(upd)))
    assert c.bytes == upd * 8 + 2 * upd * 4      # indices, values r + w
    _, c = count_ops(lambda: buf.index_copy_(0, idx, meta(upd)))
    assert c.bytes < big


def test_slice_read_charged_slice_size():
    big, sl = 1 << 20, 256
    buf = meta(big)
    _, c = count_ops(lambda: buf[1000:1000 + sl] * 2.0)
    assert c.bytes == 2 * sl * 4
    _, c = count_ops(lambda: buf.narrow(0, 7, sl).copy_(meta(sl)))
    assert c.bytes == 2 * sl * 4


def test_views_cost_nothing():
    x = meta(64, 32)
    _, c = count_ops(lambda: x.view(32, 64).t()[5:9].unsqueeze(0)
                     .permute(2, 0, 1).expand(32, 3, 4))
    assert c.bytes == 0 and c.flops == 0
    # a reshape that cannot be a view copies
    _, c = count_ops(lambda: x.t().reshape(-1))
    assert c.bytes == 2 * 64 * 32 * 4


# ---------------------------------------------------------------------------
# per-device counts on a fake (2, 2, 2) mesh
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh():
    init_fake_world(8)
    try:
        yield make_test_mesh(data=2, model=2, pod=2, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_column_row_parallel_mlp_per_device(mesh):
    bsz, d, f = 8, 64, 128
    batch = [Shard(0), Shard(0), Replicate()]
    x = distribute_tensor(meta(bsz, d), mesh, batch, src_data_rank=None)
    w1 = distribute_tensor(meta(d, f), mesh, [Replicate(), Replicate(),
                                              Shard(1)], src_data_rank=None)
    w2 = distribute_tensor(meta(f, d), mesh, [Replicate(), Replicate(),
                                              Shard(0)], src_data_rank=None)

    def mlp():
        return ((x @ w1) @ w2).redistribute(mesh, batch)

    y, c = count_ops(mlp, mesh=mesh)
    assert tuple(y.placements) == tuple(batch)
    rows, cols = bsz // 4, f // 2        # one device's rows and mlp slice
    assert c.flops == 2 * rows * d * cols * 2
    # one all-reduce of the (rows, d) partial sums over the model axis
    assert c.coll_bytes == rows * d * 4
    assert dict(c.coll_breakdown) == {"all_reduce": rows * d * 4}
    assert dict(c.coll_by_axis) == {"model": rows * d * 4}


def test_replicated_matmul_charged_to_every_device(mesh):
    m = 32
    a = distribute_tensor(meta(m, m), mesh, [Replicate()] * 3,
                          src_data_rank=None)
    _, c = count_ops(lambda: a @ a, mesh=mesh)
    assert c.flops == 2 * m ** 3
    assert c.coll_bytes == 0

"""The port's distribution path (repro_torch.distribution.kv_transfer and
grad_compress) against the JAX package's.

Bit for bit: ``quantize_sym``, ``dequantize_sym``, ``pack_int4``,
``unpack_int4``, ``_quant_roundtrip`` and the error-feedback transform (on
``quant_boundary``'s rows, whose groups sit on rounding boundaries, and on
leaves that skip quantization or take an odd group), and
``transfer_wire_bytes``.  The JAX side runs op by op, where XLA keeps
``amax / qmax`` a divide (compiled whole, its algebraic simplifier would
turn it into a multiply by the reciprocal).

The two collectives run on a two-process gloo group (this file run as a
script, one process per pod, ``file://`` rendezvous) and must equal, bit
for bit, what the JAX package's ``make_kv_transfer`` and
``make_cross_pod_grad_sync`` give on the cases of ``test_multidevice.py``
over a (pod 2, data 2, model 2) mesh of forced host devices, computed in a
JAX subprocess at the same time, compiled with XLA's algebraic
simplifier and excess precision off so that each keeps its divide and
its roundings as written.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.distribution import grad_compress as JG  # noqa: E402
from repro.distribution import kv_transfer as JK  # noqa: E402
from repro_torch.distribution import grad_compress as PG  # noqa: E402
from repro_torch.distribution import kv_transfer as PK  # noqa: E402
from repro_torch.kernels.quant_boundary import boundary_rows, round_bf16  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run torch on one CPU thread: the suite runs several test processes
    at once, and these small ops gain nothing from threads that would only
    contend with them (and with XLA's) across the processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _j(x, bf16=False):
    return jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)


def _t(x, bf16=False):
    t = torch.from_numpy(np.asarray(x, np.float32))
    return t.to(torch.bfloat16) if bf16 else t


def _same(got: torch.Tensor, want) -> None:
    w = np.asarray(want)
    g = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    if w.dtype.name in ("bfloat16", "float16"):
        w = w.astype(np.float32)
        g = got.float().numpy()
    assert g.shape == w.shape
    np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the quantizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("group", [32, 64])
@pytest.mark.parametrize("bf16", [False, True])
def test_quantize_dequantize_bit_for_bit(bits, group, bf16):
    x = boundary_rows(9, 128, group, bits, bf16, seed=bits + group)
    x = x.reshape(3, 3, 128)
    jq, js = JK.quantize_sym(_j(x, bf16), bits, group)
    pq, ps = PK.quantize_sym(_t(x, bf16), bits, group)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float16
    _same(pq, jq)
    _same(ps, js)
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32),
                       (torch.float16, jnp.float16)):
        _same(PK.dequantize_sym(pq, ps, group, dtype=dtype),
              JK.dequantize_sym(jq, js, group, dtype=jdt))
    if bits == 4:
        packed = PK.pack_int4(pq)
        _same(packed, JK.pack_int4(jq))
        _same(PK.unpack_int4(packed), JK.unpack_int4(JK.pack_int4(jq)))


def test_quantize_sym_rejects_a_group_that_does_not_divide():
    with pytest.raises(ValueError):
        PK.quantize_sym(torch.zeros(2, 10), 8, 4)


def _leaves_for_roundtrip():
    """Leaves that quantize (even groups, a last dim below the group), skip
    (last dim not a multiple of the group, a scalar) or take an odd group
    (the plain version: the kernels take even groups only, and on a CPU
    tensor the wrappers are the plain versions anyway)."""
    rng = np.random.default_rng(5)
    return {
        "w": boundary_rows(16, 128, 64, 8, False, seed=1).reshape(4, 4, 128),
        "narrow": rng.standard_normal((6, 32)).astype(np.float32),
        "skip": rng.standard_normal((5, 100)).astype(np.float32),
        "odd": rng.standard_normal((7, 3)).astype(np.float32),
        "vec": rng.standard_normal((64,)).astype(np.float32) * 1e-9,
        "s": np.asarray(rng.standard_normal(), np.float32),
    }


@pytest.mark.parametrize("bits", [4, 8])
def test_quant_roundtrip_bit_for_bit(bits):
    for name, x in _leaves_for_roundtrip().items():
        got = PG._quant_roundtrip(_t(x), bits, 64)
        want = JG._quant_roundtrip(_j(x), bits, 64)
        assert got.dtype == torch.float32, name
        _same(got, want)


@pytest.mark.parametrize("bits", [4, 8])
def test_strided_gradient_reaches_the_kernel_contiguous(bits, monkeypatch):
    """A tied embedding's gradient is the transpose of its unembedding's
    (tiny-lm's (259, 128) table: strides (1, 259)); the quant_pack kernel
    reads rows in place and refuses a strided tensor, so the round trip
    hands it contiguous rows.  Held against the plain version on the
    CPU (which the wrapper runs here) and against JAX bit for bit."""
    import repro_torch.distribution.kv_transfer as KT
    seen = []
    real = KT.quant_pack_op

    def quant_pack_op(x, bits, group):
        seen.append(x.is_contiguous())
        return real(x, bits, group)

    monkeypatch.setattr(KT, "quant_pack_op", quant_pack_op)
    x = np.random.default_rng(3).standard_normal((128, 259)).astype(
        np.float32)
    g = _t(x).t()                      # (259, 128), strides (1, 259)
    assert not g.is_contiguous()
    got = PG._quant_roundtrip(g, bits, 64)
    assert seen == [True]
    _same(got, JG._quant_roundtrip(_j(np.ascontiguousarray(x.T)), bits, 64))


@pytest.mark.parametrize("bits,group", [(4, 32), (8, 64)])
def test_error_feedback_transform_bit_for_bit(bits, group):
    leaves = _leaves_for_roundtrip()
    jt = JG.make_grad_transform(bits=bits, group=group, error_feedback=True)
    pt = PG.make_grad_transform(bits=bits, group=group, error_feedback=True)
    jstate = {"ef": JG.init_ef_state({k: _j(v) for k, v in leaves.items()})}
    pstate = {"ef": PG.init_ef_state({k: _t(v) for k, v in leaves.items()})}
    rng = np.random.default_rng(9)
    for _ in range(4):
        g = {k: (v + rng.standard_normal(v.shape).astype(np.float32) * 0.01)
             for k, v in leaves.items()}
        jh, jstate = jt({k: _j(v) for k, v in g.items()}, jstate)
        ph, pstate = pt({k: _t(v) for k, v in g.items()}, pstate)
        for k in leaves:
            _same(ph[k], jh[k])
            _same(pstate["ef"][k], jstate["ef"][k])
    nofb = PG.make_grad_transform(bits=bits, group=group,
                                  error_feedback=False)
    h, st = nofb({"w": _t(leaves["w"])}, {})
    assert st == {}
    _same(h["w"], JG._quant_roundtrip(_j(leaves["w"]), bits, group))


def test_transfer_wire_bytes_equal():
    cache = {"layer0": {"k": np.zeros((4, 32, 2, 64)),
                        "v": np.zeros((4, 32, 2, 64))},
             "conv": np.zeros((4, 6, 3)), "ssm": np.zeros((4, 8, 48)),
             "pos": np.zeros((4,)), "odd": np.zeros((2, 5, 70))}
    for bits in (16, 8, 4):
        for group in (32, 64, 128):
            want = JK.transfer_wire_bytes(
                jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape), cache),
                bits, group)
            got = PK.transfer_wire_bytes(
                jax.tree_util.tree_map(lambda a: torch.zeros(a.shape), cache),
                bits, group)
            assert got == want, (bits, group)


def test_payload_roundtrip():
    parts = [torch.arange(5, dtype=torch.int8), torch.ones(3, 2).half(),
             torch.tensor(2.5), torch.arange(6, dtype=torch.int32)]
    buf = PK.pack_payload(parts)
    assert buf.dtype == torch.uint8 and buf.numel() == 5 + 12 + 4 + 24
    back = PK.unpack_payload(buf, [(p.dtype, tuple(p.shape)) for p in parts])
    for a, b in zip(parts, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError):
        PK.unpack_payload(buf, [(torch.int8, (5,))])


# ---------------------------------------------------------------------------
# the collectives on a two-process gloo group, against the JAX mesh
# ---------------------------------------------------------------------------
_JAX_CASES = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.distribution.kv_transfer import make_kv_transfer
from repro.distribution.grad_compress import make_cross_pod_grad_sync

inp, out = sys.argv[1], sys.argv[2]
# as written: XLA's simplifier would turn amax / qmax into a multiply by
# the reciprocal, and excess precision would skip bf16 roundings
OPTS = {"xla_disable_hlo_passes": "algsimp",
        "xla_allow_excess_precision": False}
d = np.load(inp)
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
bf = lambda a: jnp.asarray(a, jnp.bfloat16)
cache = {"layer0": {"k": bf(d["k"]), "v": bf(d["v"])},
         "conv": bf(d["conv"]), "ssm": bf(d["ssm"])}
grads = {"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"]),
         "c": jnp.asarray(d["c"]), "s": jnp.asarray(d["s"])}
gspecs = {"w": P("pod", None), "b": P("pod", None), "c": P("pod", None),
          "s": P()}
res = {}
with mesh:
    for bits in (16, 8, 4):
        fn, specs = make_kv_transfer(mesh, cache, bits=bits)
        sharded = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), cache,
            specs, is_leaf=lambda x: hasattr(x, "shape"))
        got = fn.lower(sharded).compile(compiler_options=OPTS)(sharded)
        for name, x in (("k", got["layer0"]["k"]), ("v", got["layer0"]["v"]),
                        ("conv", got["conv"]), ("ssm", got["ssm"])):
            res[f"kv{bits}/{name}"] = np.asarray(x, np.float32)
    for bits in (8, 4):
        fn = make_cross_pod_grad_sync(mesh, grads, gspecs, bits=bits)
        sharded = {k: jax.device_put(v, NamedSharding(mesh, gspecs[k]))
                   for k, v in grads.items()}
        for k, v in fn.lower(sharded).compile(
                compiler_options=OPTS)(sharded).items():
            res[f"sync{bits}/{k}"] = np.asarray(v)
np.savez(out, **res)
"""


def _inputs(path: Path) -> None:
    rng = np.random.default_rng(0)
    np.savez(path,
             k=round_bf16(rng.standard_normal((4, 32, 2, 64))),
             v=round_bf16(rng.standard_normal((4, 32, 2, 64)) * 3),
             conv=round_bf16(rng.standard_normal((4, 6, 3))),
             ssm=round_bf16(rng.standard_normal((4, 8, 48))),
             w=rng.standard_normal((8, 64)).astype(np.float32),
             b=rng.standard_normal((8, 3)).astype(np.float32),
             c=rng.standard_normal((8, 100)).astype(np.float32),
             s=np.asarray(1.25, np.float32))


def _pod_main(rank: int, init: str, inp: str, out: str) -> None:
    """One pod of the gloo group: the port's collectives on this rank's
    share (batch rows of the cache, rows of the gradients)."""
    import torch.distributed as dist
    from repro_torch.models.convert import flatten

    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=2)
    d = np.load(inp)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    rows = slice(2 * rank, 2 * rank + 2)
    cache = {"layer0": {"k": bf(d["k"][rows]), "v": bf(d["v"][rows])},
             "conv": bf(d["conv"][rows]), "ssm": bf(d["ssm"][rows])}
    g_rows = slice(4 * rank, 4 * rank + 4)
    grads = {k: torch.from_numpy(d[k][g_rows]) for k in ("w", "b", "c")}
    grads["s"] = torch.from_numpy(d["s"])
    res = {}
    for bits in (16, 8, 4):
        fn = PK.make_kv_transfer(None, bits=bits)
        for path, x in flatten(fn(cache)):
            assert x.dtype == torch.bfloat16
            res[f"kv{bits}/{path[-1]}"] = x.float().numpy()
        res[f"wire{bits}"] = np.asarray(
            [fn.wire_bytes, PK.transfer_wire_bytes(cache, bits)])
    for bits in (8, 4):
        for k, v in PG.make_cross_pod_grad_sync(None, bits=bits)(
                grads).items():
            res[f"sync{bits}/{k}"] = v.numpy()
    np.savez(out, **res)
    dist.destroy_process_group()


def test_collectives_on_gloo_equal_jax_mesh(tmp_path):
    _inputs(tmp_path / "in.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX_CASES, str(tmp_path / "in.npz"),
         str(tmp_path / "jax.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen(
        [sys.executable, __file__, str(r), str(tmp_path / "init"),
         str(tmp_path / "in.npz"), str(tmp_path / f"pod{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log[-4000:]
    want = np.load(tmp_path / "jax.npz")
    for r in (0, 1):
        got = np.load(tmp_path / f"pod{r}.npz")
        rows, g_rows = slice(2 * r, 2 * r + 2), slice(4 * r, 4 * r + 4)
        for bits in (16, 8, 4):
            for name in ("k", "v", "conv", "ssm"):
                np.testing.assert_array_equal(
                    got[f"kv{bits}/{name}"], want[f"kv{bits}/{name}"][rows],
                    f"pod {r} bits {bits} {name}")
            sent, formula = got[f"wire{bits}"]
            assert sent == formula, (r, bits)
        for bits in (8, 4):
            for k in ("w", "b", "c"):
                np.testing.assert_array_equal(
                    got[f"sync{bits}/{k}"], want[f"sync{bits}/{k}"][g_rows],
                    f"pod {r} sync bits {bits} {k}")
            np.testing.assert_array_equal(got[f"sync{bits}/s"],
                                          want[f"sync{bits}/s"])
    # bits 16 is the neighbour's cache exactly
    k = np.load(tmp_path / "in.npz")["k"]
    np.testing.assert_array_equal(np.load(tmp_path / "pod0.npz")["kv16/k"],
                                  k[2:4])


if __name__ == "__main__":
    _pod_main(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4])

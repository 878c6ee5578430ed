"""Elastic restore in the port: checkpoints written under one mesh restore
under another, between gloo processes (this file run as a script per
rank), and across the packages against the JAX package on a forced
8-device CPU mesh — the counterpart of ``tests/test_elastic_restore.py``.

  - 4 ranks save ``w`` from a (2, 2) mesh as (Replicate, Shard(1)); 2
    ranks restore it on a (1, 2) mesh with both dims sharded: placements
    as asked, values bit-equal;
  - a JAX checkpoint saved from a (2, 4) mesh restores on the port's
    mesh, and the port's restores on the JAX mesh, bit for bit;
  - on a (2, 2, 2) mesh every rank's shard under ``(("pod", "data"),
    None)`` equals the JAX device's shard at the same mesh coordinates;
    the KV transfer and the gradient sync given the mesh run on its
    "pod" groups;
  - the decode step's cache write into a sequence-sharded DTensor cache
    equals the write into a plain one, and the cross entropy of logits
    sharded along their vocabulary equals the plain one (rtol 1e-6, its
    gradient rtol 1e-5: the sums run in another order).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).parent.parent
W = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
X = np.arange(8 * 6, dtype=np.float32).reshape(8, 6) * 0.5

_JAX_SAVE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.checkpoint import CheckpointManager
mesh = make_mesh((2, 4), ("data", "model"))
w = jnp.asarray(np.arange(8 * 16, dtype=np.float32).reshape(8, 16) * 3.0)
w = jax.device_put(w, NamedSharding(mesh, P(None, "model")))
CheckpointManager(sys.argv[1]).save(2, {"w": w}, metadata={"mesh": "2x4"})
print("saved")
"""

_JAX_RESTORE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.checkpoint import CheckpointManager
mesh = make_mesh((2, 4), ("data", "model"))
mgr = CheckpointManager(sys.argv[1])
out = mgr.restore({"w": jnp.zeros((8, 16), jnp.float32)}, step=1,
                  shardings={"w": NamedSharding(mesh, P("data", "model"))})
np.testing.assert_array_equal(
    np.asarray(out["w"]), np.arange(8 * 16, dtype=np.float32).reshape(8, 16))
assert out["w"].sharding.spec == P("data", "model")
print("restored")
"""

_JAX_SHARDS = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_mesh
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6) * 0.5
xs = jax.device_put(jnp.asarray(x),
                    NamedSharding(mesh, P(("pod", "data"), None)))
where = {d.id: idx for idx, d in np.ndenumerate(mesh.devices)}
out = {}
for shard in xs.addressable_shards:
    coord = where[shard.device.id]
    out["_".join(map(str, coord))] = np.asarray(shard.data)
np.savez(sys.argv[1], **out)
"""


def _rank_main(role: str, rank: int, world: int, init: str, ckpt: str,
               out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard, \
        distribute_tensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distribution.sharding import to_named, to_placements
    from repro_torch.launch.mesh import make_test_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    res = {}
    if role == "save22":
        mesh = make_test_mesh(data=2, model=2)
        w = distribute_tensor(torch.from_numpy(W.copy()), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        CheckpointManager(ckpt).save(1, {"w": w}, metadata={"mesh": "2x2"})
    elif role == "restore12":
        mesh = make_test_mesh(data=1, model=2)
        spec = ("data", "model")
        shardings = to_named({"w": spec}, mesh)
        template = {"w": torch.zeros(8, 16)}
        got = CheckpointManager(ckpt).restore(template, step=1,
                                              shardings=shardings)["w"]
        assert isinstance(got, DTensor)
        assert tuple(got.placements) == to_placements(spec, mesh) == \
            (Shard(0), Shard(1))
        res["local"] = got.to_local().numpy()
        res["full"] = got.full_tensor().numpy()
        jax_ckpt = CheckpointManager(ckpt + "_jax").restore(
            template, step=2, shardings=shardings)["w"]
        res["jax_local"] = jax_ckpt.to_local().numpy()
        res["jax_full"] = jax_ckpt.full_tensor().numpy()
        res.update(_cache_write_cases(mesh))
        res.update(_vocab_nll_cases(mesh))
    elif role == "shards222":
        from repro_torch.distribution.grad_compress import \
            make_cross_pod_grad_sync
        from repro_torch.distribution.kv_transfer import make_kv_transfer
        mesh = make_test_mesh(data=2, model=2, pod=2)
        x = distribute_tensor(torch.from_numpy(X.copy()), mesh,
                              to_placements((("pod", "data"), None), mesh),
                              src_data_rank=None)
        coord = mesh.get_coordinate()
        res["coord"] = np.asarray(coord)
        res["shard"] = x.to_local().numpy()
        # the cross-pod paths on the mesh's "pod" groups
        cache = {"k": torch.full((2, 4, 1, 8), float(rank),
                                 dtype=torch.bfloat16)}
        res["kv"] = make_kv_transfer(mesh, bits=16)(cache)["k"].float() \
            .numpy()
        grads = {"g": torch.full((2, 64), float(rank))}
        res["sync"] = make_cross_pod_grad_sync(mesh, bits=8)(grads)["g"] \
            .numpy()
    np.savez(out, **res)
    dist.destroy_process_group()


def _cache_write_cases(mesh):
    """``_merge_decode_updates`` into a DTensor cache sharded along its
    sequence against the same write into a plain cache."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.transformer import _merge_decode_updates
    res = {}
    g = torch.Generator().manual_seed(0)
    for name, pos in (("scalar", torch.tensor(5, dtype=torch.int32)),
                      ("slots", torch.tensor([3, 4], dtype=torch.int32)),
                      ("edge", torch.tensor(7, dtype=torch.int32))):
        full = torch.randn(2, 2, 8, 1, 4, generator=g).to(torch.bfloat16)
        upd = torch.randn(2, 2, 1, 1, 4, generator=g).to(torch.bfloat16)
        plain = {"blocks": {"layer0": {"k": full.clone(), "v": full.clone()}},
                 "prefix": {}}
        new = {"blocks": {"layer0": {"k_new": upd, "v_new": upd}},
               "prefix": {}}
        _merge_decode_updates(new, plain, pos)
        # blocks, batch replicated; the sequence over the model axis
        spec = [Replicate(), Shard(2)]
        dt = {"blocks": {"layer0": {
            k: distribute_tensor(full.clone(), mesh, spec, src_data_rank=None)
            for k in ("k", "v")}}, "prefix": {}}
        dt_new = {"blocks": {"layer0": {
            k: distribute_tensor(upd, mesh, [Replicate(), Replicate()],
                                 src_data_rank=None)
            for k in ("k_new", "v_new")}}, "prefix": {}}
        _merge_decode_updates(dt_new, dt, pos)
        res[f"cache_{name}_want"] = plain["blocks"]["layer0"]["k"].float() \
            .numpy()
        res[f"cache_{name}_got"] = dt["blocks"]["layer0"]["k"] \
            .full_tensor().float().numpy()
    return res


def _vocab_nll_cases(mesh):
    """``steps.cross_entropy`` of logits whose vocabulary is sharded over
    the model axis (the vocabulary-parallel NLL) against the same loss of
    the plain logits: the loss and the logits' gradient."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distribution.steps import cross_entropy
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(2, 3, 10, generator=g) * 4
    targets = torch.randint(0, 10, (2, 3), generator=g)
    mask = torch.tensor([[1.0, 1.0, 0.0], [1.0, 1.0, 1.0]])
    plain = logits.clone().requires_grad_()
    want = cross_entropy(plain, targets, mask)
    want.backward()
    sharded = distribute_tensor(logits.clone(), mesh, [Replicate(), Shard(2)],
                                src_data_rank=None).requires_grad_()
    got = cross_entropy(sharded, distribute_tensor(
        targets, mesh, [Replicate(), Replicate()], src_data_rank=None),
        distribute_tensor(mask, mesh, [Replicate(), Replicate()],
                          src_data_rank=None))
    got.backward()
    return {"nll_want": want.detach().numpy(),
            "nll_got": got.full_tensor().detach().numpy(),
            "nll_grad_want": plain.grad.numpy(),
            "nll_grad_got": sharded.grad.full_tensor().numpy()}


def _spawn(args, env):
    return subprocess.Popen(args, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _ranks(role, world, tmp, env):
    return [_spawn([sys.executable, __file__, role, str(r), str(world),
                    str(tmp / f"init_{role}"), str(tmp / "ckpt"),
                    str(tmp / f"{role}_{r}.npz")], env)
            for r in range(world)]


def _wait(procs):
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log[-4000:]


def test_elastic_restore_across_meshes_and_packages(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               OMP_NUM_THREADS="1")
    # phase 1: the saves and the (2, 2, 2) shards, all at once
    jax_save = _spawn([sys.executable, "-c", _JAX_SAVE,
                       str(tmp_path / "ckpt_jax")], env)
    jax_shards = _spawn([sys.executable, "-c", _JAX_SHARDS,
                         str(tmp_path / "jax_shards.npz")], env)
    procs = [jax_save, jax_shards] + _ranks("save22", 4, tmp_path, env) \
        + _ranks("shards222", 8, tmp_path, env)
    _wait(procs)
    # phase 2: the restores, each package of the other's checkpoint too
    jax_restore = _spawn([sys.executable, "-c", _JAX_RESTORE,
                          str(tmp_path / "ckpt")], env)
    _wait([jax_restore] + _ranks("restore12", 2, tmp_path, env))

    manifest = json.loads((tmp_path / "ckpt" / "step_00000001" /
                           "manifest.json").read_text())
    assert manifest["shapes"] == [[8, 16]] and \
        manifest["metadata"] == {"mesh": "2x2"}
    for r in (0, 1):
        got = np.load(tmp_path / f"restore12_{r}.npz")
        cols = slice(8 * r, 8 * r + 8)
        np.testing.assert_array_equal(got["local"], W[:, cols])
        np.testing.assert_array_equal(got["full"], W)
        np.testing.assert_array_equal(got["jax_local"], (W * 3.0)[:, cols])
        np.testing.assert_array_equal(got["jax_full"], W * 3.0)
        for name in ("scalar", "slots", "edge"):
            np.testing.assert_array_equal(got[f"cache_{name}_got"],
                                          got[f"cache_{name}_want"], name)
        # the vocabulary-parallel NLL sums in another order
        np.testing.assert_allclose(got["nll_got"], got["nll_want"],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["nll_grad_got"], got["nll_grad_want"],
                                   rtol=1e-5, atol=1e-7)

    want = np.load(tmp_path / "jax_shards.npz")
    seen = set()
    for r in range(8):
        got = np.load(tmp_path / f"shards222_{r}.npz")
        key = "_".join(map(str, got["coord"]))
        seen.add(key)
        np.testing.assert_array_equal(got["shard"], want[key], key)
        pod, rest = divmod(r, 4)
        peer = (1 - pod) * 4 + rest           # same (data, model), other pod
        assert (got["kv"] == peer).all(), (r, got["kv"].ravel()[:4])
        np.testing.assert_allclose(got["sync"], (r + peer) / 2, rtol=1e-2)
    assert seen == set(want.files)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
               sys.argv[5], sys.argv[6])

"""The port's dry-run (repro_torch.launch.dryrun) end to end on the fake
512-rank group: tiny-lm's train and decode cells on both production
meshes, each row's useful FLOPs equal to the JAX package's
``model_flops_for`` and its useful ratio in (0, 1]; a reduced mamba and a
reduced MoE arch in every cell on both meshes; ``--include-transfer``'s
KV migration against both packages' ``transfer_wire_bytes``."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import SHAPES_BY_NAME, get_config, supported_shapes  # noqa: E402
from repro.launch.roofline import model_flops_for  # noqa: E402

ROOT = Path(__file__).parent.parent


def test_dryrun_tiny_both_meshes(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tiny-lm", "--shape", "train_4k,decode_32k", "--mesh", "both",
         "--out", str(out)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert r.stdout.count("[ok]") == 4, r.stdout
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert {(row["shape"], row["mesh"]) for row in rows} == {
        (s, m) for s in ("train_4k", "decode_32k")
        for m in ("16x16", "2x16x16")}
    cfg = get_config("tiny-lm")
    for row in rows:
        shape = SHAPES_BY_NAME[row["shape"]]
        assert row["status"] == "ok"
        assert row["model_flops"] == model_flops_for(
            cfg, shape.kind, shape.seq_len, shape.global_batch)
        assert 0 < row["useful_ratio"] <= 1, row
        assert row["chips"] == (512 if row["mesh"] == "2x16x16" else 256)
        assert row["hlo_flops"] > 0 and row["hlo_bytes"] > 0
        assert row["mem_per_device"] > 0 and row["fits_hbm"]
        assert row["note"] == {"16x16": "counted on 16x16 (data, model)",
                               "2x16x16": "counted on 32x16 (data, model)"
                               }[row["mesh"]]


def _dryrun(tmp_path, *args, timeout=300):
    out = tmp_path / "dryrun.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out",
         str(out)], capture_output=True, text=True, timeout=timeout,
        env=env, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    return r.stdout, [json.loads(line) for line in out.read_text().splitlines()]


@pytest.mark.parametrize("arch", ["falcon-mamba-7b-reduced",
                                  "deepseek-moe-16b-reduced"])
def test_dryrun_reduced_mamba_and_moe_both_meshes(tmp_path, arch):
    """The mamba stack (its scan counted as one step times its trip count)
    and the MoE einsum form (dispatch and combine as each rank's own
    product) trace every supported cell on both meshes."""
    stdout, rows = _dryrun(tmp_path, "--arch", arch, "--shape", "all",
                           "--mesh", "both")
    want = {(s, m) for s in supported_shapes(get_config(arch))
            for m in ("16x16", "2x16x16")}
    assert {(r["shape"], r["mesh"]) for r in rows} == want
    assert stdout.count("[ok]") == len(want) >= 6, stdout
    for row in rows:
        assert row["status"] == "ok"
        assert row["hlo_flops"] > 0 and row["hlo_bytes"] > 0
        assert row["useful_ratio"] > 0
        if row["shape"] == "train_4k":
            # data parallel: the gradients are reduced across the batch
            assert row["coll_by_axis"].get("data", 0) > 0, row


def _shard_shape(shape, spec, sizes):
    out = []
    for dim, entry in zip(shape, spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        out.append(dim // math.prod(sizes[a] for a in axes))
    return tuple(out)


@pytest.mark.parametrize("arch", ["tiny-lm", "whisper-small-reduced",
                                  "falcon-mamba-7b-reduced"])
def test_include_transfer_moves_the_quantized_shards_over_pod(tmp_path,
                                                              arch):
    """--include-transfer on a multi-pod decode cell: a ``+kvxfer4``
    report whose collective bytes, all over "pod", are the 4-bit shards'
    wire bytes by both packages' ``transfer_wire_bytes`` (the port's on
    meta tensors, the JAX package's on numpy arrays of the shard shapes):
    the KV caches (whisper's self and cross-attention KV) and the mamba
    states, the conv windows' odd trailing dim shipped as it is."""
    import torch

    from repro.distribution.kv_transfer import \
        transfer_wire_bytes as jax_wire_bytes
    from repro_torch.configs import SHAPES_BY_NAME as P_SHAPES
    from repro_torch.configs import get_config as port_config
    from repro_torch.distribution.kv_transfer import transfer_wire_bytes
    from repro_torch.distribution.sharding import cache_pspecs
    from repro_torch.models import init_cache
    from repro_torch.models.convert import leaves

    stdout, rows = _dryrun(tmp_path, "--arch", arch, "--shape",
                           "decode_32k", "--mesh", "multi",
                           "--include-transfer")
    (row,) = rows
    x = row["transfer"]
    assert x["shape"] == "decode_32k+kvxfer4" and x["model_flops"] == 0
    assert x["mesh"] == "2x16x16" and x["chips"] == 512
    assert "+kvxfer" in stdout

    cfg, shape = port_config(arch), P_SHAPES["decode_32k"]
    b, s = shape.global_batch, shape.seq_len
    caches = (init_cache(cfg, b, min(cfg.dec_seq, s), enc_len=s,
                         device="meta") if cfg.encoder_decoder
              else init_cache(cfg, b, s, device="meta"))

    class Mesh:
        mesh_dim_names, shape = ("pod", "data", "model"), (2, 16, 16)

    sizes = dict(zip(Mesh.mesh_dim_names, Mesh.shape))
    shards = [_shard_shape(t.shape, spec, sizes) for t, spec in
              zip(leaves(caches), leaves(cache_pspecs(caches, Mesh())))]
    dtypes = [t.dtype for t in leaves(caches)]
    port = transfer_wire_bytes(
        {str(i): torch.empty(sh, dtype=dt, device="meta")
         for i, (sh, dt) in enumerate(zip(shards, dtypes))}, bits=4)
    jax_side = jax_wire_bytes(
        [np.empty(sh, dtype=np.float32) for sh in shards], bits=4)
    assert port == jax_side > 0
    assert x["coll_by_axis"] == {"pod": port}
    assert x["coll_bytes"] == port
    assert x["t_collective"] > 0

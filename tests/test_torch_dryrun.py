"""The port's dry-run (repro_torch.launch.dryrun) end to end on the fake
512-rank group: tiny-lm's train and decode cells on both production
meshes, each row's useful FLOPs equal to the JAX package's
``model_flops_for`` and its useful ratio in (0, 1]."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.configs import SHAPES_BY_NAME, get_config  # noqa: E402
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

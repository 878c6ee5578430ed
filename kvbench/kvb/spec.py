"""Finding a cell's files by name: the cell (``cells/<workload>.json``),
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its profile set (``profiles/<name>.jsonl``)
and the readers of its per-layer metrics (``metrics/<metric>.py``)."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]

# Keys of a configuration file that are widths or counts of the model,
# each held against the port's registry entry.
WIDTH_KEYS = ("num_layers", "d_model", "num_heads", "kv_heads", "head_dim",
              "d_ff", "vocab_size", "num_experts", "experts_per_token",
              "num_shared_experts", "moe_dense_prefix")
# Other keys of the equations the reference reads, held the same way.
EQUATION_KEYS = ("qk_norm", "tie_embeddings", "rope_theta", "rmsnorm_eps",
                 "capacity_factor", "moe_impl")


@dataclass
class Cell:
    workload: str
    entry: Dict[str, Any]      # the BENCHMARK.json workloads entry
    cell: Dict[str, Any]       # cells/<workload>.json
    config: Dict[str, Any]     # configs/<config>.json
    traffic: Dict[str, Any]    # traffic/<traffic>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    root: Path


def _read(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise FileNotFoundError(f"missing {path}")
    return json.loads(path.read_text())


def load_cell(workload: str, bench_json: Path,
              root: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``bench_json``, with the metrics that
    apply to it: an end-to-end metric without a ``workloads`` list applies
    to every cell, as does a per-layer one."""
    bench = _read(bench_json)
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in {bench_json}; "
                       f"known: {sorted(entries)}")
    entry = entries[workload]

    def applies(m):
        return workload in m.get("workloads", [workload])

    return Cell(
        workload=workload, entry=entry,
        cell=_read(root / "cells" / f"{workload}.json"),
        config=_read(root / "configs" / f"{entry['config']}.json"),
        traffic=_read(root / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        root=root)


def check_registry(config: Dict[str, Any]) -> None:
    """Every width and equation key of the configuration file equals the
    port's registry entry, or the run fails: the file says what is run."""
    from repro_torch.configs import get_config

    reg = get_config(config["registry"])
    bad = []
    for key in WIDTH_KEYS + EQUATION_KEYS:
        if key not in config:
            continue
        got = (reg.resolved_head_dim if key == "head_dim"
               else getattr(reg, key))
        if got != config[key]:
            bad.append(f"{key}: file {config[key]!r}, registry {got!r}")
    if bad:
        raise ValueError(f"configuration {config['name']} disagrees with "
                         f"the port's registry entry "
                         f"{config['registry']!r}: " + "; ".join(bad))


def metric_reader(root: Path, name: str) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"kvbench_metric_{name.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def profile_path(root: Path, name: str) -> Path:
    return root / "profiles" / f"{name}.jsonl"

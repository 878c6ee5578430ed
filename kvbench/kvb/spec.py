"""Finding a cell's files by name: the cell (``cells/<workload>.json``),
its configuration (``configs/<config>.json``) and the module that file
names (``load_model``), its traffic mix (``traffic/<traffic>.json``), its
profile set (``profiles/<name>.jsonl``) and the readers of its per-layer
metrics (``metrics/<metric>.py``)."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    workload: str
    entry: Dict[str, Any]      # the BENCHMARK.json workloads entry
    cell: Dict[str, Any]       # cells/<workload>.json
    config: Dict[str, Any]     # configs/<config>.json
    model: ModuleType          # the module the configuration names
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
    config = _read(root / "configs" / f"{entry['config']}.json")

    def applies(m):
        return workload in m.get("workloads", [workload])

    return Cell(
        workload=workload, entry=entry,
        cell=_read(root / "cells" / f"{workload}.json"),
        config=config, model=load_model(root, config),
        traffic=_read(root / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        root=root)


def load_model(root: Path, config: Dict[str, Any]) -> ModuleType:
    """The module the configuration's ``"reference"`` key names, a path
    under ``root``: everything the harness needs that depends on the
    model's layout.  A layer's cache is a tuple of parts, in the module's
    order, each compared part by part.  The module provides:

    * ``forward(cfg, params, prompts, cont, strategies, lowp=False,
      on_kv=None)``: the plain forward (f32, or fp8 operands for the
      control) over each prompt, its KV quantized by the request's
      profile, and its served tokens: (first-token logits (B, V), logits
      after each served token (B, S1, V)); ``on_kv(layer, parts)`` gets
      each layer's prompt cache after the profile, (B, S, H, W) a part;
    * ``supported(strategy)``: whether its arithmetic covers a profile;
    * ``payload_parts(payload, device)``: a wire payload decoded into the
      parts, (L, H, S, W) f32 each, by plain arithmetic;
      ``payload_bytes(payload)``: its wire bytes by the harness's count;
    * ``landed_parts(dw, idx, seq)``: the first layer's parts as decode
      worker ``dw`` landed them in arena slot ``idx``, (H, S, W) each;
    * ``warm_cache(cfg, seq, device, pipeline)``: the request-sized cache
      set-up compresses once a profile, built by the program's
      ``pipeline`` module;
    * ``sizes(cfg)``: the model's counts for ``kvb.counts``;
    * ``init_scale(path, shape)``: the standard deviation of a weight
      leaf (0: zeros) for ``kvb.weights``."""
    if "reference" not in config:
        raise KeyError(f"configuration {config.get('name')!r} names no "
                       f"\"reference\" module")
    path = root / config["reference"]
    if not path.is_file():
        raise FileNotFoundError(f"configuration {config.get('name')!r}: "
                                f"no module {path}")
    name = "kvbench_model_" + "_".join(
        Path(config["reference"]).with_suffix("").parts)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod        # as an import would: dataclasses look
    spec.loader.exec_module(mod)   # their module up there
    return mod


def check_registry(config: Dict[str, Any]) -> None:
    """Every key of the configuration file that names a field of the
    port's ``ModelConfig`` (``name`` aside; ``head_dim`` against the
    resolved head size) equals the registry entry's, or the run fails:
    the file says what is run."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig

    reg = get_config(config["registry"])
    fields = {f.name for f in dataclasses.fields(ModelConfig)} - {"name"}
    bad = []
    for key in sorted(fields & set(config)):
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

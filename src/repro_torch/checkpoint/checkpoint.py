"""Fault-tolerant checkpointing with elastic restore, in PyTorch.

The counterpart of the JAX package's ``checkpoint/checkpoint.py``, with
its on-disk layout, so either package restores what the other wrote:
  - every leaf is written as its own .npy under <dir>/step_<k>/, in the
    JAX tree's flatten order (dict keys sorted at every level), with a
    JSON manifest (step, leaf count, shapes/dtypes, user metadata) written
    LAST — a checkpoint without a manifest is incomplete and ignored on
    restore, so a writer crash can never corrupt the restore path;
  - ``save(..., background=True)`` copies every leaf to host memory
    synchronously and writes on a thread (training continues during I/O,
    and may update its tensors in place meanwhile);
  - ``save`` takes DTensor leaves too: every rank gathers each one
    (``full_tensor``) and rank 0 writes the files, the same files as for
    plain tensors;
  - ``restore`` maps leaves onto a *template* tree and places them on
    ``device``, or with ``shardings`` (a matching tree of ``(mesh,
    placements)``) as DTensors on the current mesh — restoring onto
    another device or mesh than the one that wrote the checkpoint
    (elastic scaling) is just a different placement;
  - ``keep`` bounds disk usage by pruning old steps after a successful
    write.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models.convert import leaves, tree_map


def _host(x) -> np.ndarray:
    """A host copy of a leaf that later in-place updates cannot reach (a
    DTensor gathered whole: a collective, so every rank calls it)."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def latest_step(self) -> Optional[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                steps.append(int(p.name.split("_")[1]))
        return max(steps) if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None,
             background: bool = False) -> None:
        """Write a checkpoint; ``background=True`` returns after the host
        snapshot and flushes on a writer thread."""
        self.wait()
        flat = leaves(tree)
        host = [_host(x) for x in flat]
        sharded = any(isinstance(x, DTensor) for x in flat)
        if sharded and dist.get_rank() != 0:
            dist.barrier()          # rank 0 writes; the others wait for it
            return

        def _write():
            d = self._step_dir(step)
            tmp = d.with_suffix(".tmp")
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for i, arr in enumerate(host):
                np.save(tmp / f"leaf_{i:05d}.npy", arr)
            manifest = {
                "step": step,
                "n_leaves": len(host),
                "shapes": [list(a.shape) for a in host],
                "dtypes": [str(a.dtype) for a in host],
                "metadata": metadata or {},
                "written_at": time.time(),
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if d.exists():
                shutil.rmtree(d)
            tmp.rename(d)
            self._prune()

        if background and not sharded:
            self._pending = threading.Thread(target=_write, daemon=True)
            self._pending.start()
        else:
            _write()
            if sharded:
                dist.barrier()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _prune(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*") if (p / "manifest.json").exists())
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, template: Any, step: Optional[int] = None,
                device=None, shardings: Any = None) -> Any:
        """Restore onto ``template``'s structure (nested dicts; its leaves
        give only their count and places).  Leaves land on ``device``, or
        where the template's leaf lies when it is None.  ``shardings`` (a
        tree like ``template`` of ``(mesh, placements)`` leaves, as
        ``distribution.sharding.to_named`` gives them; a None leaf is
        placed as without it) lands each leaf as a DTensor on the current
        mesh, every rank keeping its own shard of the file's array."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        n = len(leaves(template))
        if manifest["n_leaves"] != n:
            raise ValueError(f"leaf count mismatch: ckpt "
                             f"{manifest['n_leaves']} vs template {n}")
        host = iter([np.load(d / f"leaf_{i:05d}.npy") for i in range(n)])

        def place(t, sharding=None):
            arr = torch.from_numpy(next(host))
            if sharding is not None:
                mesh, placements = sharding
                # each rank read the whole file: no scatter from a source
                return distribute_tensor(arr.to(mesh.device_type), mesh,
                                         placements, src_data_rank=None)
            dev = device if device is not None else (
                t.device if isinstance(t, torch.Tensor) else "cpu")
            return arr.to(dev)

        if shardings is None:
            return tree_map(place, template)
        return tree_map(place, template, shardings)

    def metadata(self, step: Optional[int] = None) -> Dict:
        if step is None:
            step = self.latest_step()
        d = self._step_dir(step)
        return json.loads((d / "manifest.json").read_text())["metadata"]

"""Mesh construction, the counterpart of the JAX package's
``launch/mesh.py``.

A mesh is a ``DeviceMesh`` over the default process group; every function
here is called explicitly (importing this module touches no distributed
state).  Single pod: (16, 16) = 256 devices, axes (data, model).  Multi-pod:
(2, 16, 16) = 512 devices, axes (pod, data, model) — the ``pod`` axis
carries PD-disaggregation traffic (see distribution/kv_transfer.py).

``init_fake_world`` starts PyTorch's fake process group: n ranks in one
process, whose collectives move nothing.  It is the counterpart of
``--xla_force_host_platform_device_count`` and serves the shape-only
dry-run (``launch/dryrun.py``) and the tests, never a serving or training
path.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda") -> DeviceMesh:
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {world} — start a "
            "process group of that size (launch/dryrun.py runs on the fake "
            "group of 512)")
    if world == n:
        return init_device_mesh(device_type, tuple(shape),
                                mesh_dim_names=axes)
    # the first n ranks, as the JAX package takes the first n devices
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_test_mesh(data: int = 2, model: int = 2, pod: Optional[int] = None,
                   device_type: str = "cpu") -> DeviceMesh:
    """Small mesh for unit tests (a gloo or fake group of that size)."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         device_type)
    return make_mesh((data, model), ("data", "model"), device_type)


def init_fake_world(world_size: int, rank: int = 0) -> None:
    """The fake process group of ``world_size`` ranks in this process (the
    dry-run and the tests only)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)

"""Roofline terms of a step against an NVIDIA H100 SXM: the counterpart of
the JAX package's ``launch/roofline.py``, with the H100's numbers in place
of the TPU's.

Hardware model, per GPU:
  PEAK_FLOPS  989e12 FLOP/s  dense bf16 tensor-core peak of the H100 SXM5
              (NVIDIA H100 Tensor Core GPU datasheet; 1,979 TFLOP/s is the
              2:4-sparse figure)
  HBM_BW      3.35e12 B/s    HBM3 bandwidth of the H100 SXM5 (datasheet)
  HBM         80e9 B         HBM3 capacity of the H100 SXM5 (datasheet)
  NVLINK_BW   450e9 B/s      NVLink 4, 900 GB/s bidirectional per GPU
              (datasheet), one direction, for a group inside one 8-GPU node
  IB_BW       50e9 B/s       one 400 Gb/s InfiniBand NDR port per GPU
              (DGX H100 design: eight ConnectX-7 ports per node), for a
              group that crosses nodes

Ranks are row-major on the mesh, eight to a node, so a mesh axis whose
group spans more than eight consecutive ranks, or strides past them,
crosses nodes.

Terms (seconds, per device; ``op_cost`` counts what one device runs):
  compute    = flops / PEAK_FLOPS
  memory     = bytes / HBM_BW        (bytes unfused: an upper bound)
  collective = sum over the mesh axes of the collective bytes on that
               axis / the bandwidth of its link
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Dict, Optional

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_PER_CHIP = 80e9
NVLINK_BW = 450e9
IB_BW = 50e9
GPUS_PER_NODE = 8


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float           # per device (counted ops; the JAX name kept)
    hlo_bytes: float           # per device, unfused
    coll_bytes: float          # per device
    coll_breakdown: Dict[str, float]
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops: float         # global useful FLOPs (6*N*D)
    useful_ratio: float        # model_flops / (hlo_flops * chips)
    mem_per_device: Optional[float] = None  # bytes (params+opt+inputs+caches)
    fits_hbm: Optional[bool] = None
    note: str = ""
    coll_by_axis: Optional[Dict[str, float]] = None   # per device, by mesh axis

    def terms(self) -> Dict[str, float]:
        return {"compute": self.t_compute, "memory": self.t_memory,
                "collective": self.t_collective}

    def to_json(self) -> str:
        return json.dumps(asdict(self))


def axis_link_bw(mesh) -> Dict[str, float]:
    """{mesh axis: the bandwidth of its group's link}: NVLink when the
    group of rank 0 along that axis stays inside one node, else InfiniBand
    (every group along an axis is congruent in a row-major layout)."""
    if mesh is None:
        return {}
    ranks = mesh.mesh
    out = {}
    for i, name in enumerate(mesh.mesh_dim_names):
        idx = [0] * ranks.dim()
        idx[i] = slice(None)
        group = ranks[tuple(idx)].flatten().tolist()
        same_node = min(group) // GPUS_PER_NODE == max(group) // GPUS_PER_NODE
        out[name] = NVLINK_BW if same_node else IB_BW
    return out


def analyze(cost, *, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops: float, mem_per_device: Optional[float] = None,
            link_bw: Optional[Dict[str, float]] = None) -> RooflineReport:
    """The report from ``op_cost.OpCost`` counts; ``link_bw`` maps each
    mesh axis to its link's bandwidth (``axis_link_bw``)."""
    link_bw = link_bw or {}
    t_c = cost.flops / PEAK_FLOPS
    t_m = cost.bytes / HBM_BW
    t_x = sum(nb / link_bw.get(axis, IB_BW)
              for axis, nb in cost.coll_by_axis.items())
    dominant = max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
                   key=lambda kv: kv[1])[0]
    useful = model_flops / max(cost.flops * chips, 1.0)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=cost.flops, hlo_bytes=cost.bytes,
        coll_bytes=cost.coll_bytes,
        coll_breakdown=dict(cost.coll_breakdown),
        t_compute=t_c, t_memory=t_m, t_collective=t_x, dominant=dominant,
        model_flops=model_flops, useful_ratio=useful,
        mem_per_device=mem_per_device,
        fits_hbm=(None if mem_per_device is None
                  else mem_per_device <= HBM_PER_CHIP),
        coll_by_axis=dict(cost.coll_by_axis),
    )


def model_flops_for(cfg, shape_kind: str, seq: int, batch: int) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode: D = batch
    new tokens; train adds the backward 2x (6ND already includes fwd+bwd:
    2ND fwd + 4ND bwd)."""
    n_active = cfg.active_param_count()
    if shape_kind == "train":
        d_tokens = seq * batch
        return 6.0 * n_active * d_tokens
    if shape_kind == "prefill":
        d_tokens = seq * batch
        return 2.0 * n_active * d_tokens
    # decode: one token per sequence
    return 2.0 * n_active * batch

"""The multi-pod dry-run: every (arch × shape × mesh) cell's train, prefill
or decode step placed on the production meshes and counted against the
H100, the counterpart of the JAX package's ``launch/dryrun.py``.

The JAX package lowers each cell on 512 placeholder devices; here the
process joins PyTorch's fake process group of 512 ranks as rank 0
(``launch/mesh.py::init_fake_world``), places every parameter, optimizer
moment, input and cache as a DTensor over meta tensors by the resolved
specs (``distribution/sharding.py``), runs the port's own step
(``distribution/steps.py``) on them and counts what rank 0 runs
(``launch/op_cost.py``).  Nothing is allocated and no collective moves
data.  Run it in its own process: the fake group is this process's default
group.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tiny-lm \\
      --shape train_4k,decode_32k --mesh both --out build/dryrun.jsonl

Each cell prints ``[ok] {arch} × {shape} × {mesh}: dominant=... tc= tm=
tx= useful= ...`` or ``[FAIL] ... <reason>``; any failure makes the exit
code 1.  ``--include-transfer`` also counts, on each multi-pod decode
cell, the compressed cross-pod KV migration of the cell's caches (4-bit,
group 64: ``kv_transfer.make_mesh_kv_transfer``), printed as a
``+kvxfer`` line and kept in the row's ``transfer``.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import sys
import time
import traceback
from typing import Dict, List, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import (
    ASSIGNED_ARCHS,
    SHAPES_BY_NAME,
    get_config,
    supported_shapes,
)
from repro_torch.distribution.optimizer import OptConfig, init_opt_state
from repro_torch.distribution.sharding import (
    cache_pspecs,
    inputs_pspecs,
    to_placements,
    tree_pspecs,
)
from repro_torch.distribution.steps import (
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.distribution.kv_transfer import make_mesh_kv_transfer
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.launch.op_cost import count_ops
from repro_torch.launch.roofline import (
    RooflineReport,
    analyze,
    axis_link_bw,
    model_flops_for,
)
from repro_torch.models import init_cache, init_params, make_inputs_for_shape
from repro_torch.models.axes import param_axes
from repro_torch.models.convert import tree_map

WORLD = 512
TRANSFER_BITS = 4     # --include-transfer's quantizer (group 64)


@functools.lru_cache(maxsize=None)
def counting_mesh(mesh):
    """The mesh the step is counted on.  On the multi-pod mesh "pod" and
    "data" shard nothing but the batch, and always together
    (``LOGICAL_RULES["batch"]``), so the (2, 16, 16) cells are counted on
    its (32, 16) flattening, whose first axis, named "data", is pod ×
    data: the same ranks in the same order.  On the three dimensions
    DTensor splits and reduces over ("pod", "data") a mesh dimension at a
    time: two chunk-and-copy steps where the flattening takes one, and two
    sequential all-reduces of the whole operand where one over the
    flattened group does (its own warning calls that plan suboptimal and
    asks for the dimensions to be flattened), and an MoE train step
    redistributes piece by piece there and takes minutes a cell on a CPU.
    Every other op, the memory a device holds and the "model" collectives
    are the same both ways (``tests/test_torch_dryrun_mesh.py``).  The
    model code's hints and the batch rule name ("pod", "data") and keep
    the axes the mesh has, here the one "data".  A row's ``note`` names
    the mesh it was counted on."""
    names = tuple(mesh.mesh_dim_names)
    if names[:2] != ("pod", "data"):
        return mesh
    shape = tuple(mesh.shape)
    return DeviceMesh(mesh.device_type,
                      mesh.mesh.reshape((shape[0] * shape[1],) + shape[2:]),
                      mesh_dim_names=("data",) + names[2:])


def _flat_spec(spec, mesh, specs_mesh):
    """A spec of the multi-pod mesh on its flattening (``counting_mesh``)."""
    if mesh is specs_mesh:
        return spec
    out = []
    for entry in spec:
        if entry == ("pod", "data"):
            entry = "data"
        elif entry in ("pod", "data") or isinstance(entry, tuple):
            raise ValueError(f"spec entry {entry!r}: pod and data shard the "
                             "batch only together on the counting mesh")
        out.append(entry)
    return tuple(out)


def place(tree, specs, mesh, specs_mesh):
    """Each tensor leaf as a DTensor on ``mesh`` with the placements of its
    spec on ``specs_mesh`` (a None spec leaves the leaf as it is: a static
    input such as ``max_len``).  Meta leaves are split locally
    (``src_data_rank=None``: no scatter)."""
    if isinstance(tree, dict):
        return {k: place(v, specs[k], mesh, specs_mesh)
                for k, v in tree.items()}
    if specs is None or not isinstance(tree, torch.Tensor):
        return tree
    return distribute_tensor(
        tree, mesh, to_placements(_flat_spec(specs, mesh, specs_mesh), mesh),
        src_data_rank=None)


def local_bytes(tree) -> int:
    """Bytes one device holds of a tree of DTensors and tensors."""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, DTensor):
        t = tree.to_local()
        return t.numel() * t.element_size()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def run_cell(cfg, shape, mesh):
    """Place and count one step on ``mesh``; returns (OpCost, bytes per
    device of parameters, optimizer state, inputs and caches).  ``mesh``
    None counts the step on one device (the 1x1 mesh: plain meta tensors,
    no process group)."""
    specs_mesh, mesh = mesh, mesh and counting_mesh(mesh)
    kind = shape.kind
    # serving cells read bf16 weights; training keeps f32 masters
    p_dtype = torch.bfloat16 if kind in ("prefill", "decode") else torch.float32
    params = init_params(cfg, dtype=p_dtype, device="meta")
    inputs = make_inputs_for_shape(cfg, shape, device="meta")
    if mesh is not None:
        params = place(params, tree_pspecs(param_axes(cfg), params,
                                           specs_mesh), mesh, specs_mesh)
        inputs = place(inputs, inputs_pspecs(inputs, specs_mesh), mesh,
                       specs_mesh)
    mem = local_bytes(params) + local_bytes(inputs)
    with implicit_replication(), torch.no_grad() if kind != "train" \
            else torch.enable_grad():
        if kind == "train":
            opt = init_opt_state(params)
            mem += local_bytes(opt)
            step = make_train_step(cfg, OptConfig(), remat=True)
            _, cost = count_ops(step, params, opt, inputs["batch"], mesh=mesh)
        elif kind == "prefill":
            max_len = inputs["max_len"]
            step = make_prefill_step(cfg, max_len=max_len)
            # the caches the step fills, placed as the decode cells' are
            batch = inputs["batch"]
            b = batch["tokens"].shape[0]
            caches = (init_cache(cfg, b, max_len, enc_len=shape.seq_len,
                                 device="meta") if cfg.encoder_decoder
                      else init_cache(cfg, b, max_len, device="meta"))
            if mesh is not None:
                caches = place(caches, cache_pspecs(caches, specs_mesh),
                               mesh, specs_mesh)
            mem += local_bytes(caches)
            _, cost = count_ops(step, params, batch, caches, mesh=mesh)
        else:
            step = make_decode_step(cfg)
            _, cost = count_ops(step, params, inputs["caches"],
                                inputs["tokens"], inputs["pos"], mesh=mesh)
    return cost, mem


@functools.lru_cache(maxsize=None)
def _production_mesh(multi_pod: bool):
    """One mesh object a process: DTensor caches its sharding decisions
    by equal meshes, and a cached decision redistributes over the groups
    of the mesh it was made on, so a second equal mesh's collectives
    would run on groups ``op_cost`` cannot name."""
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def one_device_report(cfg, shape, name: str = "") -> RooflineReport:
    """The report of ``shape``'s step of ``cfg`` on one H100 (a 1x1 mesh),
    for a step that a card runs for real beside it."""
    cost, mem = run_cell(cfg, shape, None)
    return analyze(cost, arch=name or cfg.name, shape=shape.name,
                   mesh_name="1x1", chips=1,
                   model_flops=model_flops_for(cfg, shape.kind,
                                               shape.seq_len,
                                               shape.global_batch),
                   mem_per_device=float(mem))


def transfer_report(arch: str, shape_name: str, mesh) -> RooflineReport:
    """The compressed cross-pod KV migration of a decode cell
    (``kv_transfer.make_mesh_kv_transfer``, ``TRANSFER_BITS``) counted
    per device, reported as ``<shape>+kvxfer<bits>`` with no useful
    FLOPs.  The caches are placed on the multi-pod ``mesh`` itself, not
    its flattening (the migration moves over "pod"), as the JAX dry-run
    takes them: for an encoder-decoder the cross-attention KV of the
    cell's ``seq_len`` frames beside a self cache of at most ``dec_seq``
    positions."""
    cfg, shape = get_config(arch), SHAPES_BY_NAME[shape_name]
    b = shape.global_batch
    caches = (init_cache(cfg, b, min(cfg.dec_seq, shape.seq_len),
                         enc_len=shape.seq_len, device="meta")
              if cfg.encoder_decoder
              else init_cache(cfg, b, shape.seq_len, device="meta"))
    local = tree_map(lambda t: t.to_local(),
                     place(caches, cache_pspecs(caches, mesh), mesh, mesh))
    _, cost = count_ops(make_mesh_kv_transfer(mesh, bits=TRANSFER_BITS),
                        local, mesh=mesh)
    return analyze(cost, arch=arch,
                   shape=f"{shape_name}+kvxfer{TRANSFER_BITS}",
                   mesh_name="x".join(map(str, mesh.shape)),
                   chips=math.prod(mesh.shape), model_flops=0.0,
                   mem_per_device=float(local_bytes(local)),
                   link_bw=axis_link_bw(mesh))


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool,
                include_transfer: bool = False) -> Dict:
    """Count one (arch × shape × mesh) cell; returns its report, and on a
    multi-pod decode cell with ``include_transfer`` the KV migration's
    (``transfer_report``)."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    mesh = _production_mesh(multi_pod)
    counted = counting_mesh(mesh)
    t0 = time.time()
    cost, mem = run_cell(cfg, shape, mesh)
    report = analyze(
        cost, arch=arch, shape=shape_name,
        mesh_name="x".join(map(str, mesh.shape)),
        chips=math.prod(mesh.shape),
        model_flops=model_flops_for(cfg, shape.kind, shape.seq_len,
                                    shape.global_batch),
        mem_per_device=float(mem), link_bw=axis_link_bw(counted))
    report.note = (f"counted on {'x'.join(map(str, counted.shape))} "
                   f"({', '.join(counted.mesh_dim_names)})")
    result = {"report": report, "trace_seconds": time.time() - t0,
              "n_ops": cost.n_ops}
    if include_transfer and multi_pod and shape.kind == "decode":
        result["transfer_report"] = transfer_report(arch, shape_name, mesh)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry-run (H100)")
    ap.add_argument("--arch", default="all",
                    help="arch id, comma list, or 'all' (assigned pool)")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="", help="write JSONL reports here")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--include-transfer", action="store_true")
    args = ap.parse_args(argv)

    init_fake_world(WORLD)
    archs = ASSIGNED_ARCHS if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    rows = []
    failures = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = supported_shapes(cfg) if args.shape == "all" \
            else args.shape.split(",")
        for shape_name in shapes:
            if shape_name not in supported_shapes(cfg):
                print(f"[skip] {arch} × {shape_name}: unsupported "
                      f"(full-attention arch, see DESIGN.md §5)")
                rows.append({"arch": arch, "shape": shape_name,
                             "status": "skipped"})
                continue
            for mp in meshes:
                tag = f"{arch} × {shape_name} × {'2x16x16' if mp else '16x16'}"
                try:
                    res = dryrun_cell(arch, shape_name, multi_pod=mp,
                                      include_transfer=args.include_transfer)
                    r: RooflineReport = res["report"]
                    print(f"[ok]  {tag}: dominant={r.dominant} "
                          f"tc={r.t_compute:.3e}s tm={r.t_memory:.3e}s "
                          f"tx={r.t_collective:.3e}s "
                          f"useful={r.useful_ratio:.2f} "
                          f"mem={r.mem_per_device / 1e9:.2f}GB "
                          f"trace={res['trace_seconds']:.1f}s", flush=True)
                    row = {"status": "ok", **json.loads(r.to_json()),
                           "trace_seconds": res["trace_seconds"],
                           "n_ops": res["n_ops"]}
                    if "transfer_report" in res:
                        x = res["transfer_report"]
                        print(f"[ok]  {tag} +kvxfer: tx={x.t_collective:.3e}s "
                              f"coll={x.coll_bytes / 1e9:.4f}GB "
                              f"{dict(x.coll_breakdown)}", flush=True)
                        row["transfer"] = json.loads(x.to_json())
                    rows.append(row)
                except Exception as e:
                    failures += 1
                    print(f"[FAIL] {tag}: {type(e).__name__}: "
                          f"{str(e).splitlines()[0] if str(e) else ''}",
                          flush=True)
                    if args.verbose:
                        traceback.print_exc()
                    rows.append({"arch": arch, "shape": shape_name,
                                 "mesh": "multi" if mp else "single",
                                 "status": "fail", "error": str(e)[:500]})

    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        print(f"wrote {len(rows)} rows to {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

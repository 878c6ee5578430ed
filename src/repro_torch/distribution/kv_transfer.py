"""Cross-pod KV migration over ``torch.distributed`` with the quantizer
fused in (DESIGN.md §7.1).

The counterpart of the JAX package's ``distribution/kv_transfer.py``.
There the migration is one compiled collective (``shard_map`` +
``ppermute`` over the ``pod`` mesh axis); here each rank of a process
group is one pod and holds its own pod's cache.  A rank quantizes its
cache leaves (``quant_pack``), sends the int codes and f16 scales to the
next rank in one message, receives the previous rank's and dequantizes
them (``dequant_unpack``) to each leaf's dtype.  The group symmetric
quantizer is the Pallas kernels' (``kernels/quant_pack.py``): scale
``max(amax / qmax, 1e-8)``, half-even ``round(x / scale)``, int4 nibbles
``q + 8`` low nibble first, ``codes * scale`` in f32; the wire carries the
f32 scale rounded to f16.

The payload's device follows the group's backend: gloo moves CPU tensors
only, so its payload is staged through host memory; NCCL takes the
device's tensors.  ``make_mesh_kv_transfer`` is the same migration
written as one program over a mesh's "pod" axis with functional
collectives, which the dry-run counts (``--include-transfer``).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.kernels import dequant_unpack_op, quant_pack_op
from repro_torch.kernels import ref
from repro_torch.models.convert import leaves, tree_map


# ---------------------------------------------------------------------------
# Symmetric group quantization along the last axis: the kernels on CUDA,
# their plain versions on the CPU.
# ---------------------------------------------------------------------------
def quantize_rows(x: torch.Tensor, bits: int, group: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, D) -> (codes, f16 scales (T, D/group)): what crosses the wire.
    Codes are int8 (T, D), or uint8 nibbles (T, D/2) when ``bits == 4``
    and the group is even.  The kernel reads rows in place, so a strided
    x (a tied embedding's gradient is its transpose's) is copied first."""
    x = x.contiguous()
    if group % 2 and x.device.type == "cpu":
        # The kernels take even groups only (two int4 codes share a byte):
        # on the card quant_pack_op raises for an odd group.  Such a group
        # comes only from a trailing dim that is odd and smaller than the
        # group, which no config the port runs has; on the CPU the plain
        # version quantizes it as the JAX package does.
        codes, scale = ref.quantize_ref(x, bits, group)
    else:
        codes, scale = quant_pack_op(x, bits, group)
    return codes, scale.to(torch.float16)


def dequantize_rows(codes: torch.Tensor, scale: torch.Tensor, bits: int,
                    group: int, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`quantize_rows`: (T, D) in ``dtype``, each
    value ``codes * f32(scale)`` rounded once to ``dtype``."""
    if group % 2 and codes.device.type == "cpu":   # as in quantize_rows
        return ref.dequantize_ref(codes, scale.float(), group, dtype=dtype)
    direct = dtype in (torch.float32, torch.bfloat16)
    out = dequant_unpack_op(codes, scale.float(), bits, group,
                            out_dtype=dtype if direct else torch.float32)
    return out if direct else out.to(dtype)


def quantize_sym(x: torch.Tensor, bits: int, group: int):
    """Per-group symmetric quant along the last axis.  Returns (codes int8,
    scales f16).  Last dim must be divisible by group."""
    d = x.shape[-1]
    if d % group:
        raise ValueError(f"quantize_sym: last dim {d}, group {group}")
    codes, scale = quantize_rows(x.reshape(-1, d), bits, group)
    if bits == 4 and group % 2 == 0:
        codes = unpack_int4(codes)
    return (codes.reshape(x.shape),
            scale.reshape(x.shape[:-1] + (d // group,)))


def dequantize_sym(q: torch.Tensor, scale: torch.Tensor, group: int,
                   dtype=torch.bfloat16) -> torch.Tensor:
    d = q.shape[-1]
    # int8 codes of any width dequantize as 8-bit codes: codes * scale
    out = dequantize_rows(q.reshape(-1, d), scale.reshape(-1, d // group),
                          8, group, dtype)
    return out.reshape(q.shape)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7] -> packed uint8 (last dim halved)."""
    return ref.pack_int4_ref(q)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    return ref.unpack_int4_ref(p)


# ---------------------------------------------------------------------------
# One ring hop of a flat byte payload
# ---------------------------------------------------------------------------
def pack_payload(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes, one after the other, as one uint8 vector."""
    return torch.cat([p.contiguous().reshape(-1).view(torch.uint8)
                      for p in parts])


def unpack_payload(buf: torch.Tensor, like: Sequence[Tuple[torch.dtype,
                                                         Tuple[int, ...]]]
                   ) -> List[torch.Tensor]:
    """The inverse of :func:`pack_payload`, given each part's dtype and
    shape."""
    out, off = [], 0
    for dtype, shape in like:
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        # clone: a view at an odd byte offset cannot change dtype
        out.append(buf[off:off + n].clone().view(dtype).reshape(shape))
        off += n
    if off != buf.numel():
        raise ValueError(f"payload of {buf.numel()} bytes, parts of {off}")
    return out


def ring_hop(group, payload: torch.Tensor, k: int) -> torch.Tensor:
    """Send ``payload`` (1-D uint8) to the rank ``k`` ahead in ``group`` and
    return what the rank ``k`` behind sent, on ``payload``'s device.  Both
    directions are posted together (``batch_isend_irecv``), so a ring of
    two cannot deadlock."""
    group = group if group is not None else dist.group.WORLD
    n, r = dist.get_world_size(group), dist.get_rank(group)
    wire = (torch.device("cpu") if dist.get_backend(group) == "gloo"
            else payload.device)
    out = payload.to(wire)
    into = torch.empty_like(out)
    ops = [dist.P2POp(dist.isend, out,
                      dist.get_global_rank(group, (r + k) % n), group),
           dist.P2POp(dist.irecv, into,
                      dist.get_global_rank(group, (r - k) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return into.to(payload.device)


# ---------------------------------------------------------------------------
# The transfer step.
# ---------------------------------------------------------------------------
def _leaf_group(x: torch.Tensor, bits: int, group: int) -> int:
    """The quantizer's group for a cache leaf, 0 where it ships as is."""
    if x.dim() < 2 or bits >= 16:
        return 0
    g = min(group, x.shape[-1])
    # bypass tiny/odd trailing dims (e.g. conv states (.., k-1=3)):
    # int4 nibble packing needs even groups, and the payload is noise
    if x.shape[-1] % g or (bits == 4 and g % 2):
        return 0
    return g


def pod_group(mesh_or_group):
    """The process group the cross-pod paths run on: a ``DeviceMesh``'s
    "pod" dimension (the JAX package's functions take a mesh), or a
    process group as it is (None: the default group)."""
    if isinstance(mesh_or_group, DeviceMesh):
        return mesh_or_group.get_group("pod")
    return mesh_or_group


def make_kv_transfer(process_group=None, bits: int = 4, group: int = 64):
    """Build the KV migration: every rank (pod) ships its cache to rank
    ``(r + 1) % n`` of ``process_group`` (a group, or a ``DeviceMesh``
    whose "pod" dimension's group it takes) and receives rank ``(r - 1) %
    n``'s.  bits=16 ships the leaves as they are; bits in {8, 4} use the
    quantizer.  Returns ``fn(cache) -> cache``; ``fn.wire_bytes`` is the
    size of the last payload sent."""
    process_group = pod_group(process_group)

    def fn(cache):
        flat = leaves(cache)
        parts, like = [], []
        for x in flat:
            g = _leaf_group(x, bits, group)
            if g == 0:
                sent = [x]
            else:
                sent = list(quantize_rows(x.reshape(-1, x.shape[-1]), bits,
                                          g))
            parts += sent
            like += [(t.dtype, tuple(t.shape)) for t in sent]
        payload = pack_payload(parts)
        del parts
        fn.wire_bytes = payload.numel()
        got = iter(unpack_payload(ring_hop(process_group, payload, 1), like))

        def land(x):
            g = _leaf_group(x, bits, group)
            if g == 0:
                return next(got)
            codes, scale = next(got), next(got)
            return dequantize_rows(codes, scale, bits, g,
                                   x.dtype).reshape(x.shape)

        return tree_map(land, cache)

    fn.wire_bytes = 0
    return fn


def make_mesh_kv_transfer(mesh: DeviceMesh, bits: int = 4, group: int = 64):
    """The migration as one program over a mesh's "pod" axis, the JAX
    package's ``make_kv_transfer`` (``shard_map`` + ``ppermute``): each
    device quantizes its shard of every cache leaf under
    :func:`_leaf_group`'s rule (the plain versions on tensors off the
    card, the kernels on it), sends the codes and the f16 scales to the
    device at its place in the next pod (``permute_tensor``, a functional
    collective that ``launch/op_cost.py`` counts on the "pod" axis), and
    dequantizes what it receives to the leaf's dtype.  Returns
    ``fn(local_cache) -> local_cache`` over each device's shards.  The
    dry-run counts it on the fake group; between real pods the
    migration runs :func:`make_kv_transfer`'s ring hop."""
    pg = mesh.get_group("pod")
    n = dist.get_world_size(pg)
    ahead = [(r + 1) % n for r in range(n)]

    def hop(t: torch.Tensor) -> torch.Tensor:
        out = funcol.permute_tensor(t.reshape(-1), ahead, pg)
        out = out.wait() if hasattr(out, "wait") else out
        return out.reshape(t.shape)

    def land(x):
        g = _leaf_group(x, bits, group)
        if g == 0:
            return hop(x)
        codes, scale = quantize_rows(x.reshape(-1, x.shape[-1]), bits, g)
        return dequantize_rows(hop(codes), hop(scale), bits, g,
                               x.dtype).reshape(x.shape)

    return lambda cache: tree_map(land, cache)


def transfer_wire_bytes(cache_example, bits: int, group: int = 64) -> int:
    """Bytes that cross the pod boundary per transfer (whole cache)."""
    total = 0
    for leaf in leaves(cache_example):
        n = int(math.prod(leaf.shape))
        g = min(group, leaf.shape[-1]) if leaf.ndim >= 2 else 0
        if bits >= 16 or leaf.ndim < 2 or leaf.shape[-1] % g \
                or (bits == 4 and g % 2):
            total += n * 2  # bf16
        else:
            total += n * bits // 8 + (n // g) * 2  # codes + f16 scales
    return total

"""How a model step runs over DTensors: where its tensors sit on the mesh
and what each rank computes.

The model code (``models/layers.py``, ``models/transformer.py``,
``distribution/steps.py``) is single-device code.  At the few places where
a step over a mesh has to decide something, it calls a hook of this
module: the residual stream's placement (``pin_batch``), attention
(``attend``), the dense decode read (``decode_attend``), the prefill's
and the decode step's cache writes (``fill``, ``write_rows``), the MoE
einsum form's dispatch and combine (``expert_einsum``), the token
lookup (``embed``), the cross entropy (``nll``) and the gradients'
placement (``grad``).  Each hook takes the plain code as its first
argument where there is one, and runs it, and nothing else, unless the
tensor the hook is about is a DTensor (the dry-run's placed steps, the
tests' steps over a gloo mesh).

Over DTensors, attention is each rank's own plain problem (its batch
rows, its KV heads, or its slice of the query positions or of a
sequence-sharded cache, whose softmax statistics are then reduced across
the "model" group), because DTensor's view rules refuse the attention's
reshapes over a sharded axis, and its strategy search over the rank-5
products takes minutes an op on three mesh dimensions.  The ops a rank
runs are then its own, so ``launch/op_cost.py`` counts them as they are.
"""
from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------
def _has_model_axis(x) -> bool:
    return isinstance(x, DTensor) and "model" in x.device_mesh.mesh_dim_names


def model_axis_size(x) -> int:
    """The size of a DTensor's "model" mesh axis (1 for a plain tensor)."""
    if not _has_model_axis(x):
        return 1
    return x.device_mesh.size(x.device_mesh.mesh_dim_names.index("model"))


def model_axis_on(x, dim):
    """A DTensor with its "model" mesh axis moved to shard ``dim`` (None:
    replicated), its other mesh axes as they are; identity for a plain
    tensor or a mesh without a "model" axis."""
    if not _has_model_axis(x):
        return x
    i = x.device_mesh.mesh_dim_names.index("model")
    placements = list(x.placements)
    placements[i] = Replicate() if dim is None else Shard(dim)
    return _to(x, tuple(placements))


def _to(x, placements):
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def _offset(x, dim: int) -> int:
    """The global index of a DTensor's first local element along ``dim``:
    each mesh dimension that shards ``dim``, in mesh order, splits what
    the ones before it left into ``torch.chunk``'s pieces (host arithmetic,
    no op dispatched)."""
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    size, offset = x.shape[dim], 0
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            piece = -(-size // mesh.size(i))
            start = min(piece * coord[i], size)
            offset += start
            size = min(piece, size - start)
    return offset if size else x.shape[dim]    # an empty shard: the end


def _wrap(local, like, placements):
    """``local`` as a DTensor of ``like``'s global shape."""
    return DTensor.from_local(local, like.device_mesh, placements,
                              run_check=False, shape=like.shape,
                              stride=local.stride())


def _all_reduce(x, op, group):
    out = funcol.all_reduce(x, op, group)
    return out.wait() if hasattr(out, "wait") else out


def pin_batch(x):
    """A DTensor activation (B, ...) redistributed to the batch rule's
    sharding alone and replicated over every other mesh axis, a pending
    sum reduced: dim 0 over all the mesh axes but "model" (("pod",
    "data"), or "data") where their product divides it, else over the
    last of them ("data").  The residual stream stays in this layout
    between sublayers, where JAX's partitioner would choose one by
    propagation; the gradient of its output is brought to the same
    layout.  Identity for a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    outer = tuple(a for a in sizes if a != "model")
    batch = ()
    for cand in (outer, outer[-1:]):
        prod = math.prod(sizes[a] for a in cand) if cand else 1
        if prod > 1 and x.shape[0] % prod == 0:
            batch = cand
            break
    placements = tuple(Shard(0) if a in batch else Replicate()
                       for a in mesh.mesh_dim_names)
    x = _to(x, placements)
    # the gradient comes back in the same layout: a pending sum (the
    # backward of a model-parallel product) is reduced here, once, where
    # DTensor would otherwise gather a weight and compute the next
    # product in full
    local = x.to_local(grad_placements=placements)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


# ---------------------------------------------------------------------------
# The hooks
# ---------------------------------------------------------------------------
def attend(fn, q, k, v, *, q_positions, k_positions, **kw):
    """Attention of the prefill, training and cross-attention paths
    (``fn`` is ``layers.multihead_attention``).  The "model" axis goes
    to the KV heads where they divide it, else to the query positions
    (each rank attends for its slice of queries over every key), else
    nowhere.  Each rank runs ``fn`` on its local tensors.  The output
    keeps q's placements, then goes to the heads where they divide the
    "model" axis (the output projection's heads meet their shard of
    ``wo``), else is gathered there: the projection flattens (batch,
    position), which DTensor cannot do over a sharded position axis.
    A decode step's cross-attention over a cache sharded along its
    positions runs as DTensor ops, which reduce the softmax statistics
    across the shards."""
    if not isinstance(q, DTensor) or _seq_sharded(k):
        return fn(q, k, v, q_positions=q_positions,
                  k_positions=k_positions, **kw)
    m = model_axis_size(q)
    if m > 1:
        if k.shape[2] % m == 0:
            q, k, v = (model_axis_on(t, 2) for t in (q, k, v))
        elif q.shape[1] % m == 0:
            q, k, v = (model_axis_on(q, 1), model_axis_on(k, None),
                       model_axis_on(v, None))
        else:
            q = model_axis_on(q, None)
    placements = tuple(q.placements)
    # K and V as q, with every key position; where q is split along
    # its positions, each rank's gradient of K and V is a partial sum
    split = [isinstance(p, Shard) and p.dim == 1 for p in placements]
    whole = tuple(Replicate() if s else p
                  for s, p in zip(split, placements))
    partial = tuple(Partial() if s else p
                    for s, p in zip(split, placements))
    k, v = _to(k, whole), _to(v, whole)
    ql = q.to_local()
    first = _offset(q, 1)
    out = fn(ql, k.to_local(grad_placements=partial),
             v.to_local(grad_placements=partial),
             q_positions=q_positions[first:first + ql.shape[1]],
             k_positions=k_positions, **kw)
    out = _wrap(out, q, placements)
    if m == 1:
        return out
    return model_axis_on(out, 2 if out.shape[2] % m == 0 else None)


def decode_attend(fn, q, k, v, ck, cv, cache_pos, **kw):
    """The dense decode read (``fn`` is
    ``layers.dense_decode_attention``), each rank's own problem on its
    batch rows: over its KV heads where the cache shards them, else
    over its slice of a cache sharded along its positions, whose
    statistics are reduced across the "model" group before the new
    tokens merge, else over the whole cache.  The output (B, S, H, D)
    has the cache's batch placements and the heads on the "model" axis
    where the cache has its KV heads there."""
    if not isinstance(ck, DTensor):
        return fn(q, k, v, ck, cv, cache_pos, **kw)
    mesh = ck.device_mesh
    names = mesh.mesh_dim_names
    mi = names.index("model") if "model" in names else None
    on_model = None if mi is None else ck.placements[mi]
    heads = isinstance(on_model, Shard) and on_model.dim == 2
    seq = isinstance(on_model, Shard) and on_model.dim == 1
    # q, k and v on the cache's batch rows, their heads as the cache's
    placements = tuple(
        Shard(2) if (i == mi and heads)
        else p if (i != mi and isinstance(p, Shard) and p.dim == 0)
        else Replicate()
        for i, p in enumerate(ck.placements))
    q, k, v = (_to(t, placements) for t in (q, k, v))
    ql = q.to_local()
    if isinstance(cache_pos, DTensor):    # () or (B,) on the batch rows
        rows = tuple(Shard(0) if cache_pos.ndim and p == Shard(0)
                     else Replicate() for p in placements)
        pos = _to(cache_pos, rows).to_local()
    elif cache_pos.dim() == 1:
        pos = cache_pos.narrow(0, _offset(q, 0), ql.shape[0])
    else:
        pos = cache_pos
    combine = None
    k_base = 0
    if seq:
        k_base = _offset(ck, 1)
        group = mesh.get_group(mi)
        combine = lambda o, mx, l: _combine_stats(o, mx, l, group)
    out = fn(ql, k.to_local(), v.to_local(), ck.to_local(),
             cv.to_local(), pos, k_base=k_base, combine=combine, **kw)
    return _wrap(out, q, placements)


def expert_einsum(fn, eq, a, b):
    """An MoE form's dispatch (``bsec,bsd->becd``) or combine
    (``becd,bsec->bsd``; ``fn`` is ``layers._einsum_bf16``), each rank's
    own product of its local shards.  ``a`` leads: each mesh axis that
    shards one of its subscripts shards the same subscript of ``b`` and
    of the output, and where ``b`` or the output lacks it, ``b`` is
    replicated there and the output is a pending sum (the combine's sum
    over the experts; the dispatch's gradient of the tokens).  DTensor's
    own einsum lowers the combine to a reshape that flattens (capacity,
    experts) with the experts sharded, which torch 2.11's view rule
    refuses."""
    if not isinstance(a, DTensor):
        return fn(eq, a, b)
    ins, out = eq.split("->")
    sa, sb = ins.split(",")
    a = _to(a, tuple(Replicate() if p.is_partial() else p
                     for p in a.placements))
    pb, gb, po = [], [], []
    for p in a.placements:
        sub = sa[p.dim] if isinstance(p, Shard) else None
        pb.append(Shard(sb.index(sub)) if sub and sub in sb else Replicate())
        gb.append(Partial() if sub and sub not in sb else pb[-1])
        po.append(Shard(out.index(sub)) if sub and sub in out
                  else Partial() if sub else Replicate())
    b = _to(b, tuple(pb))
    local = fn(eq, a.to_local(grad_placements=a.placements),
               b.to_local(grad_placements=tuple(gb)))
    shape = [None] * len(out)
    for i, sub in enumerate(out):
        shape[i] = a.shape[sa.index(sub)] if sub in sa \
            else b.shape[sb.index(sub)]
    return DTensor.from_local(local, a.device_mesh, tuple(po),
                              run_check=False, shape=torch.Size(shape),
                              stride=local.stride())


def write_rows(fn, buf, upd, start, stacked):
    """The decode step's write of the new tokens' rows into a dense
    cache (``_write_rows_sharded`` for a DTensor cache)."""
    if not isinstance(buf, DTensor):
        return fn(buf, upd, start, stacked)
    _write_rows_sharded(buf, upd, start)


def fill(fn, buf, val):
    """The prefill's write of a prompt's K/V into a cache's first rows:
    into a cache sharded along its positions each rank writes the
    prompt's rows that fall in its shard, on its local tensors (a
    slice of a sharded axis would gather into a copy, and the write
    would miss the cache)."""
    if not _seq_sharded(buf) or val.shape[1] == buf.shape[1]:
        return fn(buf, val)
    keep = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1
                 else p for p in buf.placements)
    val = _to(val, keep).to_local() if isinstance(val, DTensor) else val
    local = buf.to_local()
    first = _offset(buf, 1)
    last = min(first + local.shape[1], val.shape[1])
    if last > first:
        local[:, :last - first].copy_(
            val[:, first:last].to(local.dtype))


def embed(tok, tokens):
    """The token lookup; a DTensor table (sharded along its vocabulary)
    takes DTensor's masked lookup."""
    if isinstance(tok, DTensor):
        return F.embedding(tokens.long(), tok)
    return tok[tokens.long()]


def nll(fn, logits, targets):
    """Per-token NLL; logits sharded along their vocabulary take the
    vocabulary-parallel form (``_sharded_nll``)."""
    if _vocab_sharded(logits):
        return _sharded_nll(logits, targets)
    return fn(logits, targets)


def grad(g, p):
    """A DTensor gradient in its parameter's placement: the
    data-parallel sum is reduced once here, not again by each of the
    optimizer's uses of a pending sum."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _seq_sharded(t) -> bool:
    return isinstance(t, DTensor) and any(
        isinstance(p, Shard) and p.dim == 1 for p in t.placements)


def _combine_stats(out, m, l, group):
    """A rank's (unnormalised output, max, denominator) over its slice of
    the cache's positions -> the same over every position: the
    flash-decoding combine across the "model" group."""
    mx = _all_reduce(m, "max", group)
    w = torch.exp(m - mx)
    out = _all_reduce(out.float() * w[..., None], "sum", group)
    return out, mx, _all_reduce(l * w, "sum", group)


def _write_rows_sharded(buf, upd, start) -> None:
    """The decode step's cache write into a DTensor cache, whose sequence
    axis may be sharded, where no DTensor rule indexes into a sharded
    axis: each rank writes the rows that fall in its own shard, one new
    token at a time, on its local tensors.  A row outside the shard
    rewrites the shard's row it is clamped to with its own value, so the
    write costs the update rows, as on one device."""
    seq = buf.ndim - 3
    mesh = buf.device_mesh
    keep = tuple(Replicate() if isinstance(p, Shard) and p.dim == seq
                 else p for p in buf.placements)
    upd = upd.redistribute(mesh, keep).to_local()
    local = buf.to_local()
    start = start.to_local() if isinstance(start, DTensor) else start
    start = start - _offset(buf, seq)
    n = local.shape[seq]
    lead = (slice(None),) * (seq - 1)            # the block axis, if any
    for j in range(upd.shape[seq]):
        p = start + j                            # () or (B,)
        row = p.clamp(0, n - 1)
        ok = (p >= 0) & (p < n)
        if p.dim() == 0:                         # one row for every slot
            idx = lead + (slice(None), row[None])
            new = upd.narrow(seq, j, 1)
        else:                                    # each slot its own row
            rows = torch.arange(p.shape[0], device=p.device)
            idx = lead + (rows, row)
            ok = ok[:, None, None]
            new = upd.select(seq, j)
        local[idx] = torch.where(ok, new, local[idx])


def _vocab_sharded(logits) -> bool:
    return isinstance(logits, DTensor) and any(
        isinstance(p, Shard) and p.dim == logits.ndim - 1
        for p in logits.placements)


def _sharded_nll(logits, targets):
    """Per-token NLL of DTensor logits whose vocabulary is sharded,
    vocabulary-parallel as Megatron's: each rank reduces its slice's max,
    sum of exponentials and gold logit across the vocabulary group, and
    the backward (softmax minus one-hot) is local.  Nothing gathers the
    logits."""
    mesh, placements = logits.device_mesh, tuple(logits.placements)
    last = logits.ndim - 1
    (axis,) = [i for i, p in enumerate(placements)
               if isinstance(p, Shard) and p.dim == last]
    batch = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                  for p in placements)
    if isinstance(targets, DTensor):
        targets = targets.redistribute(mesh, batch).to_local()
    local = logits.to_local()
    nll = VocabParallelNLL.apply(local.flatten(0, -2),
                                 targets.long().flatten()
                                 - _offset(logits, last),
                                 mesh.get_group(axis))
    return DTensor.from_local(nll.reshape(local.shape[:-1]), mesh, batch,
                              run_check=False)


class VocabParallelNLL(torch.autograd.Function):
    """(N, V_local) logits and (N,) targets relative to this rank's
    vocabulary slice -> (N,) NLL over the whole vocabulary."""

    @staticmethod
    def forward(ctx, local, target, group):
        n, vl = local.shape
        inside = (target >= 0) & (target < vl)
        t = target.clamp(0, vl - 1)
        m = _all_reduce(local.detach().amax(-1), "max", group)
        e = torch.exp(local - m[:, None])
        se = _all_reduce(e.sum(-1), "sum", group)
        gold = local.gather(-1, t[:, None])[:, 0]
        gold = _all_reduce(torch.where(inside, gold, 0.0), "sum", group)
        ctx.save_for_backward(e, se, t, inside)
        return torch.log(se) + m - gold

    @staticmethod
    def backward(ctx, g):
        e, se, t, inside = ctx.saved_tensors
        grad = e / se[:, None]
        rows = torch.arange(grad.shape[0], device=grad.device)
        grad = grad.index_put((rows, t), grad[rows, t] - inside.to(grad.dtype))
        return grad * g[:, None], None, None

"""``scan(step, h0, xs)``: a recurrence over positions, the port's
counterpart of ``lax.scan``.

On real tensors it is a Python loop: ``step`` runs once per position on
that position's slices of ``xs`` (``unbind`` along dim 1), and the
per-position outputs are stacked along dim 1.  Autograd differentiates
the loop as it ran.

On shape-only tensors (meta tensors, DTensors over them, fake tensors:
what ``launch/op_cost.py`` counts), ``step`` runs twice: once on h0 as
it is (over a mesh a fresh state may be placed otherwise than the one
the steps carry, and the first step redistributes it), then once on the
state that step hands on under a trip-count scale of S - 1
(``trip_scale``): the counter multiplies each op it sees by the scale,
as the JAX package's ``hlo_cost.py`` multiplies a ``while`` body by its
trip count.  The outputs have the loop's shapes, dtypes and placements
(the stacked outputs are one position's, written out S times).  A
``torch.autograd.Function`` carries the scale into the backward (and
into remat's recomputation, which reruns the forward): the loop's
backward is S step backwards, where the last position's adds no
incoming state gradient that does not exist and the first's skips the
gradient of an initial state that needs none, so the backward runs the
steps' backwards under those scales (1, S - 2, 1), and the loop's glue
(the stacks of per-position gradients, the S - 1 sums of the constants'
gradients) under theirs.  The counts equal the loop's
(``tests/test_torch_scan.py``).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Sequence, Tuple

import torch

_SCALE = [1]


@contextmanager
def trip_scale(n: int):
    """Ops dispatched inside count ``n`` times (nested scales multiply)."""
    _SCALE.append(_SCALE[-1] * n)
    try:
        yield
    finally:
        _SCALE.pop()


def current_scale() -> int:
    """The trip-count multiplier of the ops dispatched now."""
    return _SCALE[-1]


def shape_only(t: torch.Tensor) -> bool:
    """A tensor with shapes and no values: meta, a DTensor over meta
    tensors, or a fake tensor."""
    from torch._subclasses.fake_tensor import FakeTensor
    return t.is_meta or isinstance(t, FakeTensor)


def scan(step: Callable, h0: torch.Tensor, xs: Sequence[torch.Tensor],
         consts: Sequence[torch.Tensor] = ()
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h, y = step(h, x_t, *consts)`` for each position t of the (B, S,
    ...) tensors ``xs`` (``x_t``: the tuple of their slices at t).
    Returns (the last h, the y's stacked along dim 1).  ``consts`` are
    the tensors ``step`` reads at every position that need a gradient
    (on shape-only tensors the backward returns theirs)."""
    n = xs[0].shape[1]
    if not shape_only(h0) or n == 0:
        ys = []
        h = h0
        for x_t in zip(*(x.unbind(1) for x in xs)):
            h, y = step(h, x_t, *consts)
            ys.append(y)
        return h, torch.stack(ys, dim=1)
    return _ScaledScan.apply(step, n, len(xs), h0, *xs, *consts)


def _spread(t: torch.Tensor, n: int) -> torch.Tensor:
    """t (B, ...) written out n times along a new dim 1: the bytes of a
    stack of n such tensors (n slices read, the whole written)."""
    e = t.unsqueeze(1).expand(t.shape[0], n, *t.shape[1:])
    return torch.empty_like(e).copy_(e)


class _ScaledScan(torch.autograd.Function):
    """The first step on h0 as it is, then one step on the state it
    carries under a trip-count scale of S - 1 (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, step, n, n_xs, h0, *tensors):
        ctx.set_materialize_grads(False)
        ctx.step, ctx.n, ctx.n_xs = step, n, n_xs
        ctx.save_for_backward(h0, *tensors)
        x_t, consts = _first(tensors[:n_xs]), tensors[n_xs:]
        h, y = step(h0, x_t, *consts)
        if n > 1:
            with trip_scale(n - 1):
                h, y = step(h, x_t, *consts)
        return h, _spread(y, n)

    @staticmethod
    def backward(ctx, g_h, g_ys):
        h0, *tensors = ctx.saved_tensors
        n, n_xs = ctx.n, ctx.n_xs
        xs, consts = tensors[:n_xs], tensors[n_xs:]
        want_x = [x.requires_grad for x in xs]
        want_c = [c.requires_grad for c in consts]
        with torch.enable_grad(), trip_scale(0):   # not the loop's work
            x_t = tuple(x.requires_grad_(w)
                        for x, w in zip(_first(xs, detach=True), want_x))
            c_in = tuple(c.detach().requires_grad_(w)
                         for c, w in zip(consts, want_c))
            h_in = [h0.detach().requires_grad_()]
            graphs = [ctx.step(h_in[0], x_t, *c_in)]
            if n > 1:
                h_in.append(graphs[0][0].detach().requires_grad_())
                graphs.append(ctx.step(h_in[1], x_t, *c_in))
        g_y = g_ys.select(1, 0)
        leaves = [t for t, w in zip(x_t + c_in, want_x + want_c) if w]

        def step_grads(i, g_out, with_h):
            """Position i's backward (graph 0: the first step, 1: the
            others) given the gradient of the state it hands on."""
            h, y = graphs[i]
            outs, grads = (y,), (g_y,)
            if g_out is not None:
                outs, grads = (h, y), (g_out, g_y)
            inputs = ([h_in[i]] if with_h else []) + leaves
            got = list(torch.autograd.grad(outs, inputs, grads,
                                           retain_graph=True,
                                           allow_unused=True))
            return (got.pop(0) if with_h else None), got

        # in the loop's order: position S - 1, the middle ones, position 0
        g_state, g_last = g_h, None
        if n > 1:
            g_state, g_last = step_grads(1, g_h, True)
        if n > 2:
            with trip_scale(n - 2):
                g_state, _ = step_grads(1, g_state, True)
        g_h0, g_first = step_grads(0, g_state, h0.requires_grad)
        g_last = g_last or g_first
        # the per-position gradients stacked (the unbind's backward), and
        # each constant's S gradients summed
        out = iter(zip(g_first, g_last))
        g_xs = [_spread(next(out)[1], n) if w else None for w in want_x]
        g_cs = []
        for w in want_c:
            if not w:
                g_cs.append(None)
                continue
            a, b = next(out)
            if n > 1:
                with trip_scale(n - 1):
                    a = a + b
            g_cs.append(a)
        return (None, None, None, g_h0, *g_xs, *g_cs)


def _first(xs, detach: bool = False):
    """Position 0's slices of the (B, S, ...) tensors ``xs``."""
    return tuple((x.detach() if detach else x).select(1, 0) for x in xs)

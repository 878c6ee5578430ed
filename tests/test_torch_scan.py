"""``repro_torch.utils.scan``: the mamba mixer's recurrence as one counted
step on shape-only tensors, a loop on real ones.

Counts: on meta tensors, the scaled step's ``OpCost`` (FLOPs, bytes,
collective bytes by kind and by mesh axis) equals the unrolled loop's,
which the same code runs when ``scan.shape_only`` is patched to say no,
for falcon-mamba's reduced config at S = 16 and 32 and one block of
jamba's (eight layers: attention, mamba and MoE), for the forward and
for a remat'ed train step (forward, backward and AdamW), on one device
and on a fake (2, 4) ("data", "model") mesh.  Real tensors: ``apply_mamba``
through the scan equals, bit for bit, the loop the mixer ran before it
went through ``scan``; the JAX mixer is held in ``tests/test_torch_ssm.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor.experimental import implicit_replication  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distribution.optimizer import OptConfig, init_opt_state  # noqa: E402
from repro_torch.distribution.steps import make_train_step  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import init_fake_world, make_test_mesh  # noqa: E402
from repro_torch.launch.op_cost import count_ops  # noqa: E402
from repro_torch.models import forward, init_params, ssm  # noqa: E402
from repro_torch.models.layers import COMPUTE_DTYPE, _einsum_bf16  # noqa: E402
from repro_torch.utils import scan as scan_mod  # noqa: E402
from repro_torch.distribution.sharding import inputs_pspecs, tree_pspecs  # noqa: E402
from repro_torch.models.axes import param_axes  # noqa: E402

B = 4


def _cfg(arch):
    cfg = get_config(arch)
    if cfg.attn_period:                      # one hybrid block
        cfg = dataclasses.replace(cfg, num_layers=cfg.attn_period)
    return cfg


@pytest.fixture(scope="module")
def mesh():
    init_fake_world(8)
    try:
        yield make_test_mesh(data=2, model=4, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _placed(cfg, s, mesh, dtype):
    params = init_params(cfg, dtype=dtype, device="meta")
    batch = {"tokens": torch.empty((B, s + 1), dtype=torch.int32,
                                   device="meta"),
             "mask": torch.empty((B, s), device="meta")}
    if mesh is not None:
        params = dryrun.place(params, tree_pspecs(param_axes(cfg), params,
                                                  mesh), mesh, mesh)
        batch = dryrun.place(batch, inputs_pspecs(batch, mesh), mesh, mesh)
    return params, batch


def _counts(fn, mesh, unrolled, monkeypatch):
    with monkeypatch.context() as m:
        if unrolled:
            m.setattr(scan_mod, "shape_only", lambda t: False)
        with implicit_replication():
            _, c = count_ops(fn, mesh=mesh)
    return (c.flops, c.bytes, c.coll_bytes, dict(c.coll_breakdown),
            dict(c.coll_by_axis))


CASES = [("falcon-mamba-7b-reduced", 16), ("falcon-mamba-7b-reduced", 32),
         ("jamba-v0.1-52b-reduced", 16)]


@pytest.mark.parametrize("on_mesh", [False, True], ids=["1x1", "2x4"])
@pytest.mark.parametrize("kind", ["forward", "train"])
@pytest.mark.parametrize("arch,s", CASES)
def test_scaled_step_counts_equal_the_loop(arch, s, kind, on_mesh, request,
                                           monkeypatch):
    cfg = _cfg(arch)
    m = request.getfixturevalue("mesh") if on_mesh else None
    if kind == "forward":
        params, batch = _placed(cfg, s, m, torch.bfloat16)

        def fn():
            with torch.no_grad():
                return forward(cfg, params, {"tokens": batch["tokens"]})
    else:
        params, batch = _placed(cfg, s, m, torch.float32)
        step = make_train_step(cfg, OptConfig(), remat=True)

        def fn():
            return step(params, init_opt_state(params), batch)
    # DTensor makes and keeps some index tensors on its first use of a
    # redistribution: a first run, not counted, leaves both runs equal
    _counts(fn, m, False, monkeypatch)
    want = _counts(fn, m, True, monkeypatch)
    got = _counts(fn, m, False, monkeypatch)
    assert want[0] > 0 and want[1] > 0
    if on_mesh:
        assert want[2] > 0
    assert got == want


def test_scaled_outputs_have_the_loop_shapes_and_placements(mesh,
                                                           monkeypatch):
    cfg = get_config("falcon-mamba-7b-reduced")
    params, _ = _placed(cfg, 16, mesh, torch.bfloat16)
    mix = {k: v[0] for k, v in params["blocks"]["layer0"]["mixer"].items()}
    x = dryrun.place({"x": torch.empty((B, 16, cfg.d_model),
                                       dtype=torch.bfloat16, device="meta")},
                     {"x": ("data", None, None)}, mesh, mesh)["x"]
    outs = {}
    for unrolled in (True, False):
        with monkeypatch.context() as m, implicit_replication():
            if unrolled:
                m.setattr(scan_mod, "shape_only", lambda t: False)
            y, st = ssm.apply_mamba(mix, cfg, x)
        outs[unrolled] = [(tuple(t.shape), t.dtype, tuple(t.placements))
                          for t in (y, st["ssm"], st["conv"])]
    assert outs[True] == outs[False]
    assert outs[False][1][0] == (B, cfg.d_inner, cfg.ssm_state)


def _parent_apply_mamba(params, cfg, x, state=None):
    """``apply_mamba`` as the port ran it before ``utils/scan.py``: the
    recurrence as a loop over positions, written out."""
    bsz, s, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    xz = _einsum_bf16("bsd,de->bse", x, params["in_proj"])
    x_in, z = xz[..., :di], xz[..., di:]
    x_conv, new_conv = ssm._causal_depthwise_conv(
        x_in, params["conv_w"], params["conv_b"],
        state["conv"] if state is not None else None)
    xcf = x_conv.float()
    x_conv = (xcf * torch.sigmoid(xcf)).to(COMPUTE_DTYPE)
    dt, b_mat, c_mat = ssm._ssm_params(params, cfg, x_conv)
    a = -torch.exp(params["a_log"].float())
    h = (state["ssm"].float() if state is not None
         else torch.zeros((bsz, di, n), dtype=torch.float32))
    xf = x_conv.float()
    ys = []
    for t in range(s):
        dt_t = dt[:, t]
        da = torch.exp(dt_t[..., None] * a)
        h = h * da + (dt_t * xf[:, t])[..., None] * b_mat[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c_mat[:, t]))
    y = torch.stack(ys, dim=1)
    y = y + xf * params["d_skip"].float()
    zf = z.float()
    y = y * (zf * torch.sigmoid(zf))
    out = _einsum_bf16("bsd,de->bse", y, params["out_proj"])
    return out.to(x.dtype), {"ssm": h, "conv": new_conv}


@pytest.mark.parametrize("arch", ["falcon-mamba-7b-reduced",
                                  "jamba-v0.1-52b-reduced"])
@pytest.mark.parametrize("s", [1, 16, 32])
def test_real_tensors_equal_the_parent_loop_bit_for_bit(arch, s):
    cfg = get_config(arch)
    params = init_params(cfg, seed=4, device="cpu", dtype=torch.bfloat16)
    name = next(k for k, v in params["blocks"].items()
                if "a_log" in v["mixer"])
    mix = {k: v[0] for k, v in params["blocks"][name]["mixer"].items()}
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    state = {"ssm": torch.from_numpy(rng.standard_normal(
        (2, cfg.d_inner, cfg.ssm_state)).astype(np.float32) * 0.3),
        "conv": torch.from_numpy(rng.standard_normal(
            (2, cfg.d_inner, cfg.ssm_conv - 1)).astype(np.float32)
        ).to(torch.bfloat16)}
    for st in (None, state):
        want_y, want_st = _parent_apply_mamba(mix, cfg, x, st)
        got_y, got_st = ssm.apply_mamba(mix, cfg, x, st)
        assert torch.equal(got_y, want_y)
        for k in ("ssm", "conv"):
            assert torch.equal(got_st[k], want_st[k])
    # and the gradients through the loop
    live = {k: v.detach().float().requires_grad_() for k, v in mix.items()}
    xw = x.float().requires_grad_()
    grads = []
    for fn in (_parent_apply_mamba, ssm.apply_mamba):
        y, _ = fn(live, cfg, xw.to(torch.bfloat16))
        grads.append(torch.autograd.grad(y.float().square().sum(),
                                         [xw] + list(live.values())))
    for g_want, g_got in zip(*grads):
        assert torch.equal(g_got, g_want)

"""The MoE einsum form over DTensors on real values: its dispatch and
combine as each rank's own product (``utils/dtensor_step.py::
expert_einsum``) against the plain form.  Four gloo ranks on a (2, 2)
("data", "model") mesh, this file run as a script per rank, as
``tests/test_torch_dtensor_step.py`` runs its steps.

Parameters are placed by ``tree_pspecs(param_axes(cfg), ...)`` and the
batch by ``inputs_pspecs``, as the dry-run places them.  Held for
deepseek-moe-16b's and llama4-scout's reduced configs (8 experts on the
2-way model axis; top-6-of-8 with a shared expert, and llama4-scout's
top-1 widened to top-2: at top-1 the renormalised gate w / w is 1, so
the router's gradient through the output is the rounding of 1/w - w/w²
in either run and differs between runs by 1e-3 of its scale): the MoE
layer alone (its output, aux loss and the gradients of its input and of
every expert weight), then the model's loss and every gradient.  The
model computes in f32 here, so the runs differ only in the order of the
sharded sums: every value within rtol 1e-5 of the plain one, atol 5e-5
of the leaf's largest magnitude.  A combine whose pending sum over the
experts were dropped, or a dispatch gradient of the tokens taken from
one rank's experts, is off by the order of the values.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).parent.parent
B, T = 4, 16
ARCHS = ("deepseek-moe-16b-reduced", "llama4-scout-17b-a16e-reduced")
TOP_K = {"llama4-scout-17b-a16e-reduced": 2}


def _numpy(x):
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().float().numpy().copy()


def _rank_main(rank: int, world: int, init: str, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.distribution.sharding import (
        inputs_pspecs, to_placements, tree_pspecs)
    from repro_torch.distribution.steps import loss_fn
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_params, io, layers, ssm, transformer
    from repro_torch.models.axes import param_axes
    from repro_torch.models.convert import leaves, tree_map
    from repro_torch.utils import dtensor_step

    for mod in (layers, transformer, ssm, io):
        mod.COMPUTE_DTYPE = torch.float32
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    mesh = make_test_mesh(data=2, model=2)

    def place(tree, specs):
        if isinstance(tree, dict):
            return {k: place(v, specs[k]) for k, v in tree.items()}
        if specs is None or not isinstance(tree, torch.Tensor):
            return tree
        return distribute_tensor(tree.clone(), mesh,
                                 to_placements(specs, mesh))

    calls = []
    real = dtensor_step.expert_einsum

    def counted(fn, eq, a, b):
        calls.append((eq, isinstance(a, DTensor)))
        return real(fn, eq, a, b)

    dtensor_step.expert_einsum = counted
    res = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        if arch in TOP_K:
            cfg = dataclasses.replace(cfg, experts_per_token=TOP_K[arch])
        rng = np.random.default_rng(11)
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32))
        mask = torch.from_numpy((rng.random((B, T)) < 0.8)
                                .astype(np.float32))
        params = init_params(cfg, seed=5, device="cpu")
        dparams = place(params, tree_pspecs(param_axes(cfg), params, mesh))

        # the MoE layer alone (block 0's stacked MoE weights)
        name = next(n for n, p in params["blocks"].items()
                    if "router" in p["mlp"])
        mlp = tree_map(lambda p: p[0], params["blocks"][name]["mlp"])
        dmlp = tree_map(lambda p: p[0], dparams["blocks"][name]["mlp"])
        x = torch.from_numpy(rng.standard_normal(
            (B, T, cfg.d_model)).astype(np.float32))
        dx = place({"x": x}, inputs_pspecs({"x": x}, mesh))["x"]
        calls.clear()
        live = tree_map(lambda p: p.detach().requires_grad_(), mlp)
        xw = x.detach().requires_grad_()
        yw, aw = layers.apply_moe(live, cfg, xw)
        gw = torch.autograd.grad((yw * yw).sum() + aw,
                                 [xw] + leaves(live))
        assert calls == [("bsec,bsd->becd", False),
                         ("becd,bsec->bsd", False)], calls
        calls.clear()
        with implicit_replication():
            live = tree_map(lambda p: p.detach().requires_grad_(), dmlp)
            xg = dx.detach().requires_grad_()
            yg, ag = layers.apply_moe(live, cfg, xg)
            flat = [xg] + leaves(live)
            gg = torch.autograd.grad((yg * yg).sum() + ag, flat)
            gg = [dtensor_step.grad(g, p) for g, p in zip(gg, flat)]
        assert calls == [("bsec,bsd->becd", True),
                         ("becd,bsec->bsd", True)], calls
        res[f"{arch}/moe_y"] = (_numpy(yw), _numpy(yg))
        res[f"{arch}/moe_aux"] = (_numpy(aw), _numpy(ag))
        for i, (a, b) in enumerate(zip(gw, gg)):
            res[f"{arch}/moe_grad{i}"] = (_numpy(a), _numpy(b))

        # the model's loss and every gradient
        batch = {"tokens": tokens, "mask": mask}
        dbatch = place(batch, inputs_pspecs(batch, mesh))
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        want, _ = loss_fn(cfg, live, batch)
        gw = torch.autograd.grad(want, leaves(live))
        with implicit_replication():
            live = tree_map(lambda p: p.detach().requires_grad_(), dparams)
            got, _ = loss_fn(cfg, live, dbatch)
            dflat = leaves(live)
            gg = [dtensor_step.grad(g, p) for g, p in
                  zip(torch.autograd.grad(got, dflat), dflat)]
        res[f"{arch}/loss"] = (_numpy(want), _numpy(got))
        for i, (a, b) in enumerate(zip(gw, gg)):
            res[f"{arch}/grad{i}"] = (_numpy(a), _numpy(b))
    if rank == 0:
        np.savez(out, **{f"{k}|{w}": v for k, pair in res.items()
                         for w, v in zip(("want", "got"), pair)})
    dist.destroy_process_group()


def test_moe_einsum_form_over_dtensors_equals_the_plain_form(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    init, out = tmp_path / "init", tmp_path / "moe.npz"
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), "4", str(init), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log[-4000:]
    data = np.load(out)
    names = sorted({k.split("|")[0] for k in data.files})
    for arch in ARCHS:
        kinds = {n.split("/")[1] for n in names if n.startswith(arch + "/")}
        assert {"moe_y", "moe_aux", "moe_grad0", "loss", "grad0"} <= kinds
    worst = {}
    for name in names:
        want, got = data[name + "|want"], data[name + "|got"]
        assert want.shape == got.shape, name
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-5 * scale,
                                   err_msg=name)
        if want.size:
            worst[name] = float(np.abs(got - want).max()) / max(scale, 1e-30)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    print("largest errors over the leaf's largest magnitude:", top)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])

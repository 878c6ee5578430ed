"""The model's steps over DTensors on real values (repro_torch.utils
.dtensor_step): four gloo ranks on a (2, 2) ("data", "model") mesh, this
file run as a script per rank, hold each step's ``full_tensor()`` against
the plain step on the same inputs.

Parameters are placed by ``tree_pspecs(param_axes(cfg), ...)``, inputs by
``inputs_pspecs`` and caches by ``cache_pspecs``, as the dry-run places
them.  The steps: the loss and every gradient, one whole train step
(remat, AdamW), a prefill into placed caches, and three decode steps (one
token at a scalar position, one at per-slot positions, a verify step of
three tokens), each step's logits and every cache leaf after it.  Two
configurations of tiny-lm's width:

  - ``heads``: vocabulary 256 (the embedding table and the logits sharded
    along the vocabulary: the masked lookup and the vocabulary-parallel
    NLL), 2 KV heads on the 2-way model axis (attention by KV heads);
  - ``seq``: 1 KV head, which the model axis does not divide, and
    tiny-lm's vocabulary of 259, which it does not divide either: the
    prefill and training attention split by query positions, and the
    decode cache sharded along its positions, the softmax statistics
    reduced across the shards before the new tokens merge.

The model computes in f32 here (``COMPUTE_DTYPE`` set in each rank), so
the two runs differ only in the order of the sharded sums: every value
within rtol 1e-5 of the plain one, atol 5e-5 of the leaf's largest
magnitude (the gradients, sums over every token's contributions with
cancellation, reach 1.5e-5 of it; logits, caches and parameters 2.6e-6).
A dropped partial sum, a wrong query slice or a wrong cache offset is an
error of the order of the values: before their repairs, the gradients of
K and V under the query-position split (each rank's a partial sum, taken
as the whole) were off by up to 0.75 of their largest magnitude, and a
prompt written into a sequence-sharded cache through a slice left the
cache untouched.
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
B, T, MAX_LEN = 4, 16, 32
CASES = {"heads": {"vocab_size": 256}, "seq": {"kv_heads": 1}}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _numpy(x):
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().float().numpy().copy()


def _rank_main(rank: int, world: int, init: str, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.distribution.optimizer import OptConfig, init_opt_state
    from repro_torch.distribution.sharding import (
        cache_pspecs, inputs_pspecs, to_placements, tree_pspecs)
    from repro_torch.distribution.steps import (
        loss_fn, make_decode_step, make_prefill_step, make_train_step)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_cache, init_params, io, layers, ssm
    from repro_torch.models import transformer
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

    res = {}
    for case, changes in CASES.items():
        cfg = dataclasses.replace(get_config("tiny-lm"), **changes)
        rng = np.random.default_rng(7)
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32))
        mask = torch.from_numpy((rng.random((B, T)) < 0.8)
                                .astype(np.float32))
        params = init_params(cfg, seed=3, device="cpu")
        dparams = place(params, tree_pspecs(param_axes(cfg), params, mesh))
        batch = {"tokens": tokens, "mask": mask}
        dbatch = place(batch, inputs_pspecs(batch, mesh))

        # the loss and every gradient
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        want, _ = loss_fn(cfg, live, batch)
        gw = torch.autograd.grad(want, leaves(live))
        with implicit_replication():
            live = tree_map(lambda p: p.detach().requires_grad_(), dparams)
            got, _ = loss_fn(cfg, live, dbatch)
            dflat = leaves(live)
            gg = [dtensor_step.grad(g, p) for g, p in
                  zip(torch.autograd.grad(got, dflat), dflat)]
        res[f"{case}/loss"] = (_numpy(want), _numpy(got))
        for i, (a, b) in enumerate(zip(gw, gg)):
            res[f"{case}/grad{i}"] = (_numpy(a), _numpy(b))

        # one whole train step
        oc = OptConfig()
        step = make_train_step(cfg, oc, remat=True)
        new, _, metrics = step(tree_map(torch.clone, params),
                               init_opt_state(params), batch)
        with implicit_replication():
            dnew, _, dmetrics = step(dparams, init_opt_state(dparams),
                                     dbatch)
        res[f"{case}/train_loss"] = (_numpy(metrics["loss"]),
                                     _numpy(dmetrics["loss"]))
        for k, a in _flat(new).items():
            res[f"{case}/train/{k}"] = (_numpy(a), _numpy(_flat(dnew)[k]))

        # prefill, then three decode steps on the caches it filled
        params = init_params(cfg, seed=3, device="cpu")
        dparams = place(params, tree_pspecs(param_axes(cfg), params, mesh))
        prompt = {"tokens": tokens[:, :T]}
        caches = init_cache(cfg, B, MAX_LEN, device="cpu")
        dcaches = place(caches, cache_pspecs(caches, mesh))
        prefill = make_prefill_step(cfg, max_len=MAX_LEN)
        decode = make_decode_step(cfg)
        with torch.no_grad():
            lw, caches = prefill(params, prompt, caches)
            with implicit_replication():
                lg, dcaches = prefill(
                    dparams, place(prompt, inputs_pspecs(prompt, mesh)),
                    dcaches)
            res[f"{case}/prefill"] = (_numpy(lw), _numpy(lg))
            for k, a in _flat(caches).items():
                res[f"{case}/prefill/{k}"] = (_numpy(a),
                                              _numpy(_flat(dcaches)[k]))
            steps = (
                ("decode1", tokens[:, T:T + 1], torch.tensor(T)),
                ("slots", tokens[:, 3:4],
                 torch.tensor([T + 1, T, T + 1, 12], dtype=torch.int32)),
                ("verify3", tokens[:, 5:8], torch.tensor(T + 2)),
            )
            for name, tok, pos in steps:
                inputs = {"tokens": tok, "pos": pos.to(torch.int32)}
                lw, caches = decode(params, caches, inputs["tokens"],
                                    inputs["pos"])
                dinputs = place(inputs, inputs_pspecs(inputs, mesh))
                with implicit_replication():
                    lg, dcaches = decode(dparams, dcaches,
                                         dinputs["tokens"], dinputs["pos"])
                res[f"{case}/{name}"] = (_numpy(lw), _numpy(lg))
                for k, a in _flat(caches).items():
                    res[f"{case}/{name}/{k}"] = (_numpy(a),
                                                 _numpy(_flat(dcaches)[k]))
    if rank == 0:
        np.savez(out, **{f"{k}|{w}": v for k, pair in res.items()
                         for w, v in zip(("want", "got"), pair)})
    dist.destroy_process_group()


def test_steps_over_dtensors_equal_the_plain_steps(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    init, out = tmp_path / "init", tmp_path / "steps.npz"
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), "4", str(init), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log[-4000:]
    data = np.load(out)
    names = sorted({k.split("|")[0] for k in data.files})
    for case in CASES:
        kinds = {n.split("/")[1] for n in names if n.startswith(case + "/")}
        assert {"loss", "grad0", "train_loss", "prefill", "decode1", "slots",
                "verify3"} <= kinds, (case, kinds)
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

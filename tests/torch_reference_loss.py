"""The eval-loss target and tolerance that ``chip_smoke.py`` phase 7a pins,
and the faults that the tolerance must catch:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_reference_loss.py
    PYTHONPATH=src python tests/torch_reference_loss.py --device cpu \\
        --threads 1 2 4 8
    PYTHONPATH=src python tests/torch_reference_loss.py --device cuda \\
        --fault none no-weight-decay bf16-masters constant-lr no-warmup no-clip

Every loss is on the held-out batch ``make_batch("mixed", 16, 256,
seed=chip_smoke.EVAL_SEED)`` (no training batch uses that seed), through
the port's ``make_eval_step``.

With no ``--device`` (CPU, needs JAX) it prints:
  1. the JAX-trained cached ``tiny-lm`` (``repro.core.quality``,
     ``tiny_lm_s400.npz``), which starts from the JAX package's init;
  2. the port's own trainer (``repro_torch.core.quality.
     train_reference_model``) from the port's seed-0 init;
  3. the JAX package's trainer from that same port init: phase 7a's
     target (the same init and schedule; only the arithmetic differs).

With ``--device`` it imports no JAX and trains the port's trainer there:
once per ``--threads`` count (CPU only: the count changes the order of
the CPU's sums, so the spread of these runs is what arithmetic alone
moves the loss), and once per ``--fault``, a trainer planted with that
fault (``none``: no fault).  About two minutes a run on eight cores, 15-25
s on an H100.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import EVAL_SEED  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import quality as PQ  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.distribution import optimizer as PO  # noqa: E402
from repro_torch.distribution.steps import make_eval_step  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.convert import from_flat_arrays, leaves  # noqa: E402

# fault -> (OptConfig fields it overrides, bf16 master weights)
FAULTS = {
    "none": ({}, False),
    "no-weight-decay": ({"weight_decay": 0.0}, False),
    "bf16-masters": ({}, True),
    "constant-lr": ({"schedule": "constant"}, False),
    "no-warmup": ({"warmup_steps": 0}, False),
    "no-clip": ({"grad_clip": float("inf")}, False),
}


def eval_loss(params, device) -> float:
    tokens, mask = make_batch("mixed", 16, 256, seed=EVAL_SEED)
    batch = {"tokens": torch.as_tensor(tokens).to(device),
             "mask": torch.as_tensor(mask[:, 1:]).to(device)}
    return float(make_eval_step(port_config("tiny-lm"))(params,
                                                         batch)["loss"])


def train_with_fault(fault: str, device) -> float:
    """``train_reference_model`` with ``fault`` planted through the names
    it looks up when called; both are restored afterwards."""
    fields, bf16 = FAULTS[fault]
    opt_config, init = PO.OptConfig, PT.init_params
    PO.OptConfig = lambda **kw: opt_config(**{**kw, **fields})
    if bf16:
        PT.init_params = lambda *a, **kw: _cast_bf16(init(*a, **kw))
    try:
        _, params, _, _ = PQ.train_reference_model(device=device,
                                                   log_every=100)
    finally:
        PO.OptConfig, PT.init_params = opt_config, init
    return eval_loss(params, device)


def _cast_bf16(tree):
    if isinstance(tree, dict):
        return {k: _cast_bf16(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16)


def jax_numbers() -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.core.quality import get_reference_model
    from repro.distribution.optimizer import OptConfig, init_opt_state
    from repro.distribution.steps import make_train_step
    from repro.models import init_params as jax_init

    cfg, pcfg = get_config("tiny-lm"), port_config("tiny-lm")

    def to_port(tree):
        return from_flat_arrays(
            [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)], pcfg,
            "cpu")

    _, jp = get_reference_model()
    cache = eval_loss(to_port(jp), "cpu")
    print(f"1. JAX-trained cache: {cache!r}", flush=True)

    _, port_trained, _, _ = PQ.train_reference_model(device="cpu",
                                                     log_every=100)
    port = eval_loss(port_trained, "cpu")
    print(f"2. port trainer, port init: {port!r}", flush=True)

    steps = PQ.REF_STEPS
    tmpl, _ = jax_init(cfg, seed=0)
    treedef = jax.tree_util.tree_structure(tmpl)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(x.numpy())
        for x in leaves(PT.init_params(pcfg, seed=0, device="cpu"))])
    oc = OptConfig(lr=3e-3, warmup_steps=max(steps // 10, 10),
                   total_steps=steps, schedule="cosine", weight_decay=0.01)
    opt = init_opt_state(params)
    step = jax.jit(make_train_step(cfg, oc, remat=False))
    for i in range(steps):
        t, m = make_batch("mixed", 16, 256, seed=i)
        params, opt, _ = step(params, opt, {"tokens": jnp.asarray(t),
                                            "mask": jnp.asarray(m[:, 1:])})
    jax_run = eval_loss(to_port(params), "cpu")
    print(f"3. JAX trainer, port init: {jax_run!r}", flush=True)
    print(f"|1 - 3| = {abs(cache - jax_run)!r}; "
          f"|2 - 3| = {abs(port - jax_run)!r}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="train the port's trainer here (no JAX)")
    ap.add_argument("--threads", type=int, nargs="*", default=[],
                    help="CPU thread counts, one run each")
    ap.add_argument("--fault", choices=sorted(FAULTS), nargs="*",
                    default=[], help="planted trainer faults, one run each")
    args = ap.parse_args()
    if args.device is None:
        jax_numbers()
        return
    for n in args.threads:
        torch.set_num_threads(n)
        loss = train_with_fault("none", args.device)
        print(f"threads {n}: eval loss {loss!r}", flush=True)
    for fault in args.fault:
        loss = train_with_fault(fault, args.device)
        print(f"fault {fault}: eval loss {loss!r}", flush=True)


if __name__ == "__main__":
    main()

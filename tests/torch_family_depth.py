"""How far a teacher-forced decode step lands from the full forward, by
depth, on random weights: the measurement behind ``chip_smoke.py``'s
phase 8b, which holds the decode against the forward at a shallow depth
(``held_depth``) and only prints the deep models' deviation.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_family_depth.py --jax
    PYTHONPATH=src python tests/torch_family_depth.py --port [--device cuda] [ARCH ...]

``--jax`` runs the JAX package on the CPU, compiled with XLA's excess
precision off, at reduced width and the given depths (seed-0 weights, 64
tokens): the decode step's logits against the forward's at the last
position, the number beyond the JAX test's gate (atol 0.15, rtol 0.05 in
units of the logits' RMS) and whether the argmax agrees.

``--port`` runs the port at full width (``chip_smoke.py``'s depth cuts,
MoE at capacity_factor 16, 256 positions from ``make_inputs``) and
prints, layer by layer, the relative deviation of the decode step's
output from the forward's at that position (max |diff| over the
forward's max): free-running, and teacher-forced, where every layer is
fed the forward's own input at that position, so each layer's own
arithmetic is measured apart from what the layers before it passed on.
The port path imports no JAX.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JAX_CASES = (("qwen3-4b", 36), ("qwen3-4b", 8), ("gemma2-9b", 42),
             ("granite-20b", 8), ("minicpm-2b", 40), ("qwen2-vl-72b", 8))


def jax_depths() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config, reduce_config
    from repro.models import transformer as JT

    for arch, layers in JAX_CASES:
        cfg = dataclasses.replace(reduce_config(get_config(arch)),
                                  num_layers=layers)
        params, _ = JT.init_params(cfg, seed=0)
        t = 64
        tokens = jnp.asarray(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (1, t + 1)), jnp.int32)

        def run(p, tk):
            full, _ = JT.forward(cfg, p, {"tokens": tk})
            _, caches = JT.prefill(cfg, p, {"tokens": tk[:, :t]},
                                   max_len=t + 1)
            dec, _ = JT.decode_step(cfg, p, caches, tk[:, t:],
                                    jnp.asarray(t, jnp.int32))
            return full[0, t], dec[0, 0]

        want, got = (np.asarray(a, np.float32) for a in
                     jax.jit(run).lower(params, tokens).compile(
                         compiler_options={
                             "xla_allow_excess_precision": False})(
                                 params, tokens))
        rms = float(np.sqrt((want ** 2).mean()))
        beyond = int((np.abs(got - want) / rms
                      > 0.15 + 0.05 * np.abs(want) / rms).sum())
        print(f"JAX {arch} reduced width, {layers} layers: decode vs "
              f"forward max|diff| {np.abs(got - want).max():.4g} (logit RMS "
              f"{rms:.4g}), {beyond} beyond the gate, argmax "
              f"{int(got.argmax())} vs {int(want.argmax())}")


def port_layers(archs, device: str) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, forward, init_params,
                                    make_inputs, prefill)
    from repro_torch.models import transformer as PT

    dev = torch.device(device)
    for arch in archs:
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, num_layers=C.FAMILY_DEPTH.get(
            arch, cfg.num_layers))
        if cfg.moe:
            cfg = dataclasses.replace(cfg, capacity_factor=16.0)
        params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
        b = make_inputs(cfg, "train", seq=C.FAMILY_SEQ, batch=1, seed=1,
                        device=dev)["batch"]
        tokens = b["tokens"]
        t = tokens.shape[1] - 1
        full = {k: v for k, v in b.items()
                if k in ("frames", "patch_embeds")}
        pos = t + (b["patch_embeds"].shape[1] if "patch_embeds" in b
                   else 0)
        if cfg.mrope:
            full["positions"] = torch.arange(
                pos + 1, dtype=torch.int32, device=dev)[None, None].expand(
                    3, 1, pos + 1)
        pre = dict(full, tokens=tokens[:, :t])
        if cfg.mrope:
            pre["positions"] = full["positions"][..., :pos]
        real = PT._apply_layer
        fwd_in, fwd_out, dec_out = [], [], []
        state = {"mode": "forward", "feed": False}

        def layer(lp, c, spec, x, **kw):
            if not kw.get("causal", True) or state["mode"] == "prefill":
                return real(lp, c, spec, x, **kw)
            if state["mode"] == "forward":
                fwd_in.append(x[:, pos:pos + 1].clone())
                out = real(lp, c, spec, x, **kw)
                fwd_out.append(out[0][:, pos:pos + 1].clone())
                return out
            if state["feed"]:
                x = fwd_in[len(dec_out)]
            out = real(lp, c, spec, x, **kw)
            dec_out.append(out[0].clone())
            return out

        PT._apply_layer = layer
        try:
            with torch.no_grad():
                forward(cfg, params, dict(full, tokens=tokens))
                for feed in (False, True):
                    state.update(mode="prefill")
                    _, caches = prefill(cfg, params, pre, max_len=pos + 1)
                    state.update(mode="decode", feed=feed)
                    dec_out.clear()
                    decode_step(cfg, params, caches, tokens[:, t:t + 1], pos)
                    devs = [float((d.float() - f.float()).abs().max()
                                  / f.float().abs().max())
                            for d, f in zip(dec_out, fwd_out)]
                    print(f"port {arch} {cfg.num_layers} layers on {dev}, "
                          f"{'teacher-forced' if feed else 'free-running'}: "
                          f"relative deviation by layer "
                          f"{[round(v, 4) for v in devs]}")
        finally:
            PT._apply_layer = real
        del params, caches
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("archs", nargs="*")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    if args.jax:
        jax_depths()
    if args.port:
        sys.path.insert(0, str(ROOT))
        import chip_smoke as C
        port_layers(args.archs or list(C.FAMILY_ARCHS), args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

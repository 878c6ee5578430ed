"""Train a small LM for a few hundred steps with checkpoint/restart and
(optionally) error-feedback gradient compression, on the PyTorch port
(``examples/train_small.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_train_small.py [--device cpu] [--steps 150] [--grad-bits 8]

Trains on ``--device`` (CUDA by default); with ``--grad-bits`` the
gradient compression's quantizer runs there as the port's ``quant_pack``
and ``dequant_unpack`` kernels.
"""
import argparse
import tempfile

from repro_torch.launch.train import train


def main(argv=None):
    """Prints the first and last loss; returns the per-step losses."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--grad-bits", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as d:
        _, _, losses = train(
            "tiny-lm", steps=args.steps, batch=8, seq=128, lr=3e-3,
            ckpt_dir=d, ckpt_every=50,
            grad_compress_bits=args.grad_bits, log_every=25,
            device=args.device)
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {len(losses)} steps")
    return {"losses": losses}


if __name__ == "__main__":
    main()

"""End-to-end training driver on the PyTorch/CUDA port: train a ~130M-param
architecture (its reduced config) for a few hundred steps with
checkpointing + fault tolerance.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--device cpu]

Checkpoints go to ``--ckpt-dir``, by default a fresh temporary directory
removed at the end.
"""
import argparse
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh "
                         "temporary one)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="repro_torch_example_") as tmp:
        losses = train_main([
            "--arch", args.arch, "--smoke",
            "--steps", str(args.steps),
            "--batch", "8", "--seq", "64",
            "--ckpt-every", "100",
            "--ckpt-dir", args.ckpt_dir or tmp,
            "--device", args.device,
        ])
    if not (losses and losses[-1] < losses[0]):
        raise RuntimeError(f"training must reduce loss: {losses[:1]} -> "
                           f"{losses[-1:]}")
    print(f"OK: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()

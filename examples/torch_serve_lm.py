"""Batched serving example on the PyTorch/CUDA port: prefill + continuous
batched decode.

  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    return serve_main(["--arch", "qwen2.5-3b", "--smoke", "--requests", "6",
                       "--prompt-len", "12", "--gen", "12",
                       "--device", args.device])


if __name__ == "__main__":
    main()

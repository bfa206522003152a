"""Batched serving example on the PyTorch port: prefill + streaming greedy
decode (``examples/serve_batch.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/serve_batch_torch.py --arch gemma3-4b
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu

Drives ``repro_torch.launch.serve``'s LM path on a smoke config.  The last
line is a JSON report of the kernel launches (the LM path reaches no TMFU
kernel).
"""

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; raises "
                         "where there is none)")
    args = ap.parse_args(argv)
    from repro_torch.kernels.tmfu import kernel as tk
    from repro_torch.launch.serve import main as serve_main
    tk.reset_launch_counts()
    rc = serve_main(["--arch", args.arch, "--smoke",
                     "--batch", str(args.batch),
                     "--prompt-len", str(args.prompt_len),
                     "--gen", str(args.gen)]
                    + (["--device", args.device] if args.device else []))
    print(json.dumps({"example": "serve_batch", "arch": args.arch,
                      "launches": dict(tk.launch_counts)}))
    return rc


if __name__ == "__main__":
    sys.exit(main())

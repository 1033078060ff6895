"""Batched serving example, twin of the reference's
``examples/serve_batched.py``: decode a few requests against a reduced
model with the KV-cache / SSM-state decode path.

    PYTHONPATH=src python -m repro_torch.serve_batched --arch mamba2-780m \\
        [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    args, rest = ap.parse_known_args(argv)
    return serve_main(["--arch", args.arch, "--requests", "4", "--slots",
                       "2", "--prompt-len", "6", "--gen-len", "8"] + rest)


if __name__ == "__main__":
    main()

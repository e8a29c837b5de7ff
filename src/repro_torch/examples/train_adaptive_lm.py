"""End to end: train a (reduced) qwen2-family model on a Zipf
token stream with the splay vocab cache adapting online, checkpointing,
and auto-resume (the twin of the reference's
``examples/train_adaptive_lm.py``).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_adaptive_lm
      [--device cpu] [--ckpt-dir DIR]

The reference's arguments, on the card.  The checkpoints go to
``build/repro_quickstart_ckpt`` under the checkout (git-ignored) unless
``--ckpt-dir`` names another place; a second run resumes there.
``main`` returns the losses.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from repro_torch.launch import train

# the reference's trainer arguments, but for the checkpoint directory
ARGV = ["--arch", "qwen2-0.5b", "--smoke",
        "--steps", "60", "--batch", "4", "--seq", "128",
        "--ckpt-every", "25", "--log-every", "10"]
CKPT_DIR = (Path(__file__).resolve().parents[3] / "build"
            / "repro_quickstart_ckpt")


def train_argv(ckpt_dir, steps=None, device="cuda") -> list:
    argv = list(ARGV)
    if steps is not None:
        argv[argv.index("--steps") + 1] = str(steps)
    return argv + ["--ckpt-dir", str(ckpt_dir), "--device", device]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    args = ap.parse_args(argv)
    return train.main(train_argv(args.ckpt_dir, device=args.device))


if __name__ == "__main__":
    main()

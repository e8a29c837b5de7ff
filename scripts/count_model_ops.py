#!/usr/bin/env python3
"""The number of ATen operators the meshless model dispatches: for each
architecture's smoke config (random weights from seed 0), one
``model_zoo.forward`` of a batch of 2 x 8 tokens and one
``model_zoo.decode_step`` from a 16-position cache, counted by a
``TorchDispatchMode`` on the CPU.  The engine's decode step is
host-bound at a few µs an operator, so a change to the model that adds
operators on the meshless path shows here before it shows on the card.

    PYTHONPATH=src python scripts/count_model_ops.py [--arch NAME ...]

``PYTHONPATH`` picks the tree whose model is counted: point it at
another checkout's ``src`` to compare two commits.  Prints one line an
architecture, then one JSON line ``{arch: {"forward": n, "decode": n}}``.
"""

from __future__ import annotations

import argparse
import json

ARCHS = ("minitron-8b", "paligemma-3b", "whisper-large-v3", "zamba2-7b",
         "phi3.5-moe-42b-a6.6b")


def count_ops(arch: str) -> dict:
    """The forward's and the decode step's operator counts of ``arch``'s
    smoke config on the CPU."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import registry
    from repro_torch.models import model_zoo as zoo

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    cfg = registry.get_smoke(arch)
    params = zoo.build_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=gen)
    front = None
    if cfg.family == "vlm":
        front = torch.randn(2, cfg.img_tokens, cfg.d_model, generator=gen)
    elif cfg.family == "encdec":
        front = torch.randn(2, cfg.enc_positions, cfg.d_model,
                            generator=gen)
    with torch.no_grad():
        with Count() as fwd:
            zoo.forward(params, cfg, toks, frontend=front)
        cache = zoo.init_cache(cfg, 2, 16, device="cpu")
        with Count() as dec:
            zoo.decode_step(params, cfg, toks[:, :1], cache, 3)
    return {"forward": fwd.n, "decode": dec.n}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    args = ap.parse_args(argv)
    out = {}
    for arch in args.arch:
        out[arch] = count_ops(arch)
        print(f"{arch}: forward {out[arch]['forward']} ops, decode step "
              f"{out[arch]['decode']} ops", flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

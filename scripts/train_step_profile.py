#!/usr/bin/env python3
"""Where a training step goes, on one NVIDIA GPU: qwen2-0.5b at full
width as configured (float32 parameters, bfloat16 compute, remat per
block; random weights from a seed), one batch of 8 x 512 Zipf tokens,
the port's ``train_step.make_train_step`` (forward, backward, AdamW).

    python3 scripts/train_step_profile.py [--steps 5] [--batch 8] [--seq 512]
        [--src PATH/src]

Prints the host clock around a synchronised step, its CUDA-event time
(medians over ``--steps`` steps after two warm-up steps), the number of
ATen operators one step dispatches (a ``TorchDispatchMode`` counter),
and from one ``torch.profiler`` trace of one step the device's busy
time (the union of the traced kernels' intervals), its kernel count and
idle share, beside the 6·N·T bound at the card's published dense bf16
rate.  Then the card's ``name, power.limit`` and one JSON line.
``chip_smoke.py`` calls :func:`profile_train_step` after its traced
phases.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def profile_train_step(torch, dev, steps=5, batch=8, seq=512, seed=0):
    """The readings of one qwen2-0.5b training step on ``dev`` (see the
    module docstring), as a dict.  The port is imported from whatever
    ``sys.path`` holds first (``main``'s ``--src``)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode
    sys.path.append(str(HERE.parent / "src"))
    import card_checks as cs
    from repro_torch.configs import registry
    from repro_torch.models import model_zoo as zoo
    from repro_torch.train import data as dm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    cfg = registry.get("qwen2-0.5b")
    params = zoo.build_params(cfg, seed=seed, device=dev)
    n_par = sum(v.numel() for v in params.values())
    state = opt.init(params)
    step_fn = ts.make_train_step(cfg)
    b = dm.SyntheticZipfData(cfg.vocab, seq, batch, seed=seed).batch_at(0)
    b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    def step():
        nonlocal params, state
        params, state, m = step_fn(params, state, b)
        return float(m["loss"])

    for _ in range(2):
        step()
    host_ms, event_ms = [], []
    for _ in range(steps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        e0.record()
        step()
        e1.record()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t))
        event_ms.append(e0.elapsed_time(e1))

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            self.ops[str(func.overloadpacket)] += 1
            return func(*a, **(kw or {}))

    with Count() as counter:
        step()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    busy = cs.device_busy(prof, n_top=8)
    host = float(np.median(host_ms))
    out = {
        "arch": cfg.name, "params": n_par, "batch": batch, "seq": seq,
        "steps": steps, "host_ms": host,
        "event_ms": float(np.median(event_ms)),
        "aten_ops_per_step": sum(counter.ops.values()),
        "top_ops": counter.ops.most_common(10),
        "bound_ms": 1e3 * 6 * n_par * batch * seq / cs.BF16_OPS,
    }
    if busy is None:
        out["device_busy_ms"] = None     # the trace held no device activity
    else:
        kev, busy_ms, _, top = busy
        out.update(device_busy_ms=busy_ms, kernels_per_step=len(kev),
                   idle_share=1 - busy_ms / host,
                   top_kernels=[(k[:70], c, us / 1e3)
                                for k, (c, us) in top])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--src", default=str(HERE.parent / "src"),
                    help="the tree of the port to time (another commit "
                         "unpacked beside this one, to compare)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    import card_checks as cs
    out = profile_train_step(torch, torch.device("cuda"), args.steps,
                             args.batch, args.seq, args.seed)
    out["card"] = cs.card_line()
    out["src"] = args.src
    print(f"train step, qwen2-0.5b, batch {args.batch} x {args.seq}: host "
          f"{out['host_ms']:.3f} ms, events {out['event_ms']:.3f} ms "
          f"(medians of {args.steps}); {out['aten_ops_per_step']} ATen ops; "
          f"traced device busy {out['device_busy_ms']} ms; 6NT bound "
          f"{out['bound_ms']:.3f} ms", flush=True)
    print(out["card"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where a model decode step of the serving engine goes, on one NVIDIA
GPU: minitron-8b at full width in bfloat16 (random weights from a seed),
batch 4, a 128-position cache filled to 16, the engine's decode cell
(``serve_step.make_decode_step``).

    python3 scripts/engine_step_profile.py [--steps 10] [--batch 4]

Prints, per decode step: the host clock around a synchronised call, the
CUDA-event time, the number of ATen operators the step dispatches (a
``TorchDispatchMode`` counter), and from one ``torch.profiler`` trace of
``--steps`` steps the device's busy time (the union of the traced
kernels' intervals), its kernel launches, its idle share and the
kernels that take the most time; beside the weight-read bound
(``card_checks.decode_bound_ms``).  Then the card's ``name,
power.limit`` and one JSON line of the numbers.  The bound, the trace's
busy time and the card line are ``scripts/card_checks.py``'s, shared
with ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, str(HERE.parent / "src"))
    import card_checks as cs
    from repro_torch.configs.minitron_8b import CONFIG
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serve import serve_step as ss

    card = cs.card_line()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(CONFIG, param_dtype="bfloat16")
    params = zoo.build_params(cfg, seed=args.seed, device=dev)
    bound_ms = cs.decode_bound_ms(params, args.batch)
    B = args.batch
    dec = ss.make_decode_step(cfg)
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(1, cfg.vocab, (B, 16)).astype(np.int32)
    tok, cache, n = ss.prefill_loop(
        dec, params, prompt, zoo.init_cache(cfg, B, 128, dev))

    def step():
        nonlocal tok, cache, n
        tok, cache = dec(params, tok, cache, n)
        n += 1

    for _ in range(3):
        step()
    torch.cuda.synchronize()

    host_ms, event_ms = [], []
    for _ in range(args.steps):
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
    n_ops = sum(counter.ops.values())

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    busy = cs.device_busy(prof, n_top=8)
    if busy is None:
        sys.exit("the profiler recorded no device activity")
    kev, busy_ms, _, top = busy
    busy_ms /= args.steps
    out = {
        "card": card, "batch": B, "steps": args.steps,
        "host_ms": float(np.median(host_ms)),
        "event_ms": float(np.median(event_ms)),
        "aten_ops_per_step": n_ops,
        "device_busy_ms_per_step": busy_ms,
        "kernels_per_step": len(kev) / args.steps,
        "idle_share": 1 - busy_ms / float(np.median(host_ms)),
        "bound_ms": bound_ms,
        "top_ops": counter.ops.most_common(12),
        "top_kernels": [(k[:70], c / args.steps, us / 1e3 / args.steps)
                        for k, (c, us) in top],
    }
    print(f"decode step, minitron-8b bf16, batch {B}: host "
          f"{out['host_ms']:.3f} ms, events {out['event_ms']:.3f} ms "
          f"(medians of {args.steps}); "
          f"{n_ops} ATen ops; traced device busy {busy_ms:.3f} ms over "
          f"{out['kernels_per_step']:.0f} kernels a step; bound "
          f"{bound_ms:.3f} ms", flush=True)
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

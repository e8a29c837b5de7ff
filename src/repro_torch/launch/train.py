"""End-to-end trainer (the twin of ``repro.launch.train``, on one
device): checkpoints with auto-resume, the straggler monitor, the
splay vocab cache's tap on the data stream, and optional gradient
compression.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --batch 8 --seq 512 --steps 10 --ckpt-dir CKPT
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --steps 20 --ckpt-dir CKPT

The weights are random, drawn from ``--seed`` by the port's builder.
A run with ``--ckpt-dir`` saves every ``--ckpt-every`` steps and at the
end, and resumes from the newest checkpoint there.  Two differences
from the reference, both on resume: the data source is positioned
*before* the prefetch thread starts, so the first batch is
``batch_at(start)`` (the reference starts the thread first, and a
resumed run reads some of batches 0, 1, 2, ... before it); and, as in
the reference, only the parameters are restored: AdamW's moments and
step count start afresh (ROADMAP §C).  Runs on the card unless
``--device cpu`` is given.  ``main`` returns the list of losses.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.splay_cache import SplayVocabCache
from repro_torch.core.splaylist import _device
from repro_torch.models import model_zoo as zoo
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt
from repro_torch.train import straggler
from repro_torch.train import train_step as ts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config for CPU")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model, the optimizer and "
                         "the vocab cache (default: the card)")
    args = ap.parse_args(argv)

    dev = _device(args.device)
    cfg = (registry.get_smoke(args.arch) if args.smoke
           else registry.get(args.arch))
    params = zoo.build_params(cfg, seed=args.seed, device=dev)
    opt_state = opt.init(params)
    step_fn = ts.make_train_step(cfg, microbatch=args.microbatch,
                                 compress=args.compress, lr=args.lr)

    cache = SplayVocabCache(cfg.vocab_padded, hot_size=cfg.hot_vocab,
                            update_prob=0.1, device=dev)
    source = data_mod.SyntheticZipfData(
        cfg.vocab, args.seq, args.batch, cache=cache, seed=args.seed)
    mon = straggler.StragglerMonitor()

    mgr = ckpt_mod.CheckpointManager(args.ckpt_dir) if args.ckpt_dir \
        else None
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        flat, extra = mgr.load()
        params = ckpt_mod.unflatten_into(
            {k: v for k, v in flat.items() if k.startswith("params/")},
            params)
        start = extra.get("data_step", mgr.latest_step())
        print(f"resumed from step {start}")
    source.step = start          # before the prefetch thread starts
    loader = data_mod.PrefetchLoader(source, prefetch=4)

    error_fb = None
    losses = []
    it = iter(loader)
    try:
        for step in range(start, args.steps):
            host_batch = next(it)
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in host_batch.items()}
            t0 = time.time()
            if args.compress:
                params, opt_state, metrics, error_fb = step_fn(
                    params, opt_state, batch, error_fb)
            else:
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0
            if mon.check(0, dt):
                print(f"straggler flagged at step {step} "
                      f"(dt={dt:.2f}s vs median {mon.median():.2f}s)")
            if step % args.log_every == 0 or step == args.steps - 1:
                hot = cache.hit_rate(np.asarray(host_batch["tokens"]))
                print(f"step {step:5d} loss {loss:.4f} "
                      f"dt {dt*1e3:6.1f}ms hot-hit {hot:.2f}")
            if mgr is not None and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, params, opt_state,
                         extra={"data_step": step + 1})
        if mgr is not None:
            mgr.save(args.steps, params, opt_state,
                     extra={"data_step": args.steps}, blocking=True)
    finally:
        loader.close()
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()

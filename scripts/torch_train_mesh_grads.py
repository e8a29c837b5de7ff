#!/usr/bin/env python3
"""Leaf by leaf, how far the sharded train step's gradients lie from the
float32 witness, on one card:

    python3 scripts/torch_train_mesh_grads.py [--out FILE]
        [--device cpu --layers N --batch B S]

The model, weights and batch are ``chip_smoke.py`` phase 17's:
qwen2-0.5b at its published widths (bf16, seed 0) and ``TRAIN_MESH_BATCH``
rows from ``card_checks.train_batch``.  Meshless, on the card: the
gradients of the float32 witness (the weights cast to float32) and of
the bf16 model (``train_step._value_and_grad``).  Then, on ``SEQ_RANKS``
gloo ranks of the card, the same gradients on phase 17's two meshes
(1 x 4 under ``dryrun.cell_rules`` of the train shape, ``cp_seq`` +
``cp_q``; 2 x 2 under the default rules, fsdp and the batch over
``data``), each in bf16 and in float32 from the same weights.  For each
run and leaf: the whole gradient's norm, and its distance (the norm of
the difference) from the witness's and from the meshless bf16 gradient,
by layer where the leaf is stacked; a block's sums of squares are summed
over the axes its spec splits, so a replicated block counts once.
Prints one line a run and a JSON object last (also written to ``--out``).
``--device cpu`` with a cut depth and batch checks the script on a host.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HERE / "src"), str(HERE / "scripts"), str(HERE)]

import chip_smoke as cs  # noqa: E402
from card_checks import card_line, train_batch  # noqa: E402

DIR = HERE / "build" / "train_grads"


def _stats(torch, g, refs, axes, split=None):
    """``{leaf: {"norm2", "d2_<ref>"}}``: a leaf's sum of squares and its
    squared distance from each of ``refs`` (``{name: {leaf: tensor}}``,
    the same blocks), a vector over the layers where the leaf is
    stacked; ``split(leaf, value)`` sums a block's value over the axes
    that split it."""
    out = {}
    for k, v in g.items():
        v = v.float()
        dims = tuple(range(1, v.dim())) if axes[k][:1] == ("layers",) \
            else tuple(range(v.dim()))
        sq = {"norm2": torch.sum(v * v, dim=dims)}
        for name, ref in refs.items():
            d = v - ref[k].float()
            sq["d2_" + name] = torch.sum(d * d, dim=dims)
        if split is not None:
            sq = {n: split(k, x) for n, x in sq.items()}
        out[k] = {n: x.double().cpu().reshape(-1).tolist()
                  for n, x in sq.items()}
    return out


def rank(mesh, job) -> dict:
    """On one rank: for each mesh and dtype, the laid-out step's loss,
    ``grad_norm`` and leaf statistics (:func:`_stats`) against the
    witness's and the meshless bf16 gradients' blocks."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.tree import tree_map
    from repro_torch.launch import dryrun
    from repro_torch.models import layers as ly
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import collectives as cl
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import elastic
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    dev = mesh.device
    cfg = job["cfg"]
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    b, s = job["batch"]["tokens"].shape
    m22 = elastic.remesh(model_parallel=2, device=dev.type)
    meshes = {"1x4": (mesh, dryrun.cell_rules(
                  cfg, ShapeConfig("t17", s, b, "train"),
                  shd.AbstractMesh(dict(mesh.shape)), False)),
              "2x2": (m22, shd.default_rules())}
    _, axes = zoo.param_axes(cfg)
    wit = {n: torch.load(f, mmap=True) for n, f in job["files"].items()}
    out = {}
    for key, (m, rules) in meshes.items():
        for dt, c in (("bf16", cfg), ("f32", cfg32)):
            p = zoo.build_params(cfg, seed=0, device=dev)
            if dt == "f32":
                p = tree_map(lambda x: x.float(), p)
            specs = ly.axes_to_specs(p, axes, m, rules)
            tree = shd.lay_out(p, specs, m, rules)
            del p
            spec = shd.resolve_spec((b,), ("batch",), m, rules)
            rows = shd.block_slices((b,), spec, m)[0]
            tb = {k: torch.as_tensor(v[rows].astype(np.int64), device=dev)
                  for k, v in job["batch"].items()}
            loss, g = ts._value_and_grad(tree, c, tb)
            gn = opt.global_norm(g)
            refs = {n: {k: shd.shard_tensor(w[k].to(dev), specs[k], m)
                        for k in w} for n, w in wit.items()}

            def split(k, x, m=m, specs=specs):
                for a in shd.spec_axes(specs[k]):
                    if m.shape[a] > 1:
                        x = cl.psum(x, m, a)
                return x
            out[f"{key} {dt}"] = {
                "loss": float(loss), "grad_norm": float(gn),
                "leaves": _stats(torch, g, refs, axes, split)}
            del tree, g, refs
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, nargs=2, default=None)
    cli = ap.parse_args()
    import torch
    if cli.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from repro_torch.core.tree import tree_map
    from repro_torch.launch import spmd
    from repro_torch.models import model_zoo as zoo
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    card = card_line() if cli.device == "cuda" else "host CPU"
    dev = torch.device(cli.device)
    t = time.perf_counter()
    cfg = cs.seq_configs()[cs.SEQ_ARCH]
    if cli.layers:
        cfg = dataclasses.replace(cfg, n_layers=cli.layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    batch = train_batch(cfg, np.random.default_rng(17),
                        *(cli.batch or cs.TRAIN_MESH_BATCH))
    tb = {k: torch.as_tensor(v.astype(np.int64), device=dev)
          for k, v in batch.items()}
    _, axes = zoo.param_axes(cfg)
    p16 = zoo.build_params(cfg, seed=0, device=dev)
    p32 = tree_map(lambda x: x.float(), p16)
    runs, grads = {}, {}
    for name, c, p in (("witness", cfg32, p32), ("meshless bf16", cfg, p16)):
        loss, g = ts._value_and_grad(p, c, tb)
        runs[name] = {"loss": float(loss),
                      "grad_norm": float(opt.global_norm(g)),
                      "leaves": _stats(torch, g, grads, axes)}
        grads[name] = g
    shutil.rmtree(DIR, ignore_errors=True)
    DIR.mkdir(parents=True)
    files = {}
    for name, g in grads.items():
        files[name] = str(DIR / (name.replace(" ", "_") + ".pt"))
        torch.save({k: v.cpu() for k, v in g.items()}, files[name])
    del grads, p16, p32
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    try:
        ranks = spmd.spawn(rank, cs.SEQ_RANKS,
                           {"cfg": cfg, "batch": batch, "files": files},
                           backend="gloo", device=cli.device, timeout=900)
    finally:
        shutil.rmtree(DIR, ignore_errors=True)
    runs.update(ranks[0])
    w = runs["witness"]["leaves"]
    for name, r in runs.items():
        line = {}
        for k, st in r["leaves"].items():
            n = float(np.sqrt(sum(w[k]["norm2"])))
            row = {"norm": round(float(np.sqrt(sum(st["norm2"]))), 6)}
            for d in ("witness", "meshless bf16"):
                if "d2_" + d in st:
                    row["rel_" + d] = round(float(
                        np.sqrt(sum(st["d2_" + d]))) / n, 6)
            line[k] = row
        print(f"[grads] {name}: loss {r['loss']}, grad_norm "
              f"{r['grad_norm']}; by leaf {line} ({card})", flush=True)
    print(f"[grads] {time.perf_counter() - t:.1f} s ({card})", flush=True)
    res = {"card": card, "runs": runs}
    if cli.out:
        Path(cli.out).parent.mkdir(parents=True, exist_ok=True)
        Path(cli.out).write_text(json.dumps(res))
    print(json.dumps({k: {"loss": r["loss"], "grad_norm": r["grad_norm"]}
                      for k, r in runs.items()}))


if __name__ == "__main__":
    main()

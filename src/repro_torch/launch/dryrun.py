"""The dry-run: every (arch x shape) cell on the production meshes,
counted on the meta device, with its roofline terms at the H100's
constants (the twin of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 256 or 512 placeholder
TPU devices and reads XLA's cost and memory analyses.  The port has no
compiler: it runs rank 0's step of the production mesh
(``launch.mesh.make_production_mesh``, an ``AbstractMesh``) on
``torch.device("meta")``, the parameters ``param_axes`` gives laid out
as that rank's blocks (``layers.axes_to_specs`` under
:func:`cell_rules`) and the inputs ``train_step.input_specs`` /
``serve_step.decode_input_specs`` give, cut to its rows.  A ``train_4k``
cell runs the whole train step (``train_step.make_train_step``: value
and grad with the reference's ``microbatch``, ``remat`` and
``compress`` options, then AdamW), its AdamW state ``optimizer.init``
of the rank's blocks.  No process group and no device memory: every
collective on meta tensors, the backward pass's too, is recorded and
returns a shaped result.  The step runs under

* ``torch.utils.flop_counter.FlopCounterMode``: matmul-class flops;
* :class:`OpBytes`, a dispatch mode that sums each aten op's input and
  output bytes, views and allocations left out: the traffic of the
  unfused program, an upper bound of a fused one's;
* ``collectives.recording()``: each collective's kind, bytes and group
  size, priced by ``roofline.tally``'s ring model.

The full-depth run gives the collectives (``collectives_fullscan``);
with ``probes`` (the single mesh), the 1-unit and 2-unit runs give the
per-unit costs, extrapolated to the depth as the reference does.
``memory_analysis`` holds the rank's argument bytes (parameters,
the AdamW state, inputs, cache); temporaries are not counted.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k \\
      --mesh single --out build/dryrun [--microbatch M] [--remat none]
  python -m repro_torch.launch.dryrun --list-cells
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as ly
from repro_torch.models import model_zoo as zoo
from repro_torch.parallel import collectives as cl
from repro_torch.parallel import sharding as shd
from repro_torch.serve import serve_step as ss
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

# the logical names of the sequence layouts a cell may turn on
SEQ_NAMES = ("seq", "kvseq", "cp_seq", "cp_q")


def cells():
    """All runnable (arch, shape) pairs; ``long_500k`` only for the
    sub-quadratic archs, as in the reference."""
    out = []
    for arch, cfg in registry.ARCHS.items():
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            if shape == "long_500k" and not registry.sub_quadratic(cfg):
                continue
            out.append((arch, shape))
    return out


def _probe_cfg(cfg, n_layers: int):
    """The reduced-depth variant of the probes: the same widths and
    layout, ``n_layers`` layers (and as many encoder layers)."""
    return dataclasses.replace(
        cfg, n_layers=n_layers, scan_layers=False,
        n_enc_layers=(n_layers if cfg.n_enc_layers else 0))


def probe_unit(cfg) -> int:
    """Layer-extrapolation unit: hybrid archs repeat in attn_every groups."""
    return cfg.attn_every if (cfg.family == "hybrid" and cfg.attn_every) \
        else 1


def cell_rules(cfg, shape, mesh, multi_pod: bool, fsdp: bool = True):
    """The rule table of one cell (the reference's ``lower_cell``
    choices): ``seq``/``kvseq`` over ``data`` when the global batch is
    smaller than the ``data`` axis; the flash-decoding cache (``kvseq``
    over ``model``) for a decode cell whose kv heads do not divide
    ``model``; the Megatron-SP stream (``cp_seq`` over ``model``) for a
    train or prefill cell whose sequence divides it, and
    context-parallel q (``cp_q``) where the heads do not."""
    seq_sharded = shape.global_batch < mesh.shape["data"]
    rules = shd.default_rules(multi_pod=multi_pod, seq_sharded=seq_sharded,
                              fsdp=fsdp)
    if shape.kind == "decode" and not seq_sharded and cfg.n_kv and \
            cfg.n_kv % mesh.shape["model"] != 0:
        rules["kvseq"] = ("model",)
    if shape.kind in ("train", "prefill") and \
            shape.seq_len % mesh.shape["model"] == 0:
        rules["cp_seq"] = ("model",)
        if cfg.n_heads and cfg.n_heads % mesh.shape["model"] != 0:
            rules["cp_q"] = ("model",)
    return rules


class OpBytes(TorchDispatchMode):
    """Sums each aten op's tensor inputs' and outputs' bytes (``total``)
    and counts the ops (``ops``); an op whose result is a view of its
    input, and an allocation that writes nothing, move no bytes."""

    _SKIP = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided")

    def __init__(self):
        super().__init__()
        self.total = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        schema = func._schema
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in schema.returns)
        if not view and func.overloadpacket.__name__ not in self._SKIP:
            self.ops += 1
            self.total += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        return out


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return 0


def _blocks(tree, specs, mesh):
    """Meta tensors of this rank's block shapes of a global meta tree."""
    return {k: (_blocks(v, specs[k], mesh) if isinstance(v, dict)
                else torch.empty(shd.local_shape(v.shape, specs[k], mesh),
                                 dtype=v.dtype, device="meta"))
            for k, v in tree.items()}


def _rows(x, mesh, rules):
    """This rank's rows (its block over ``batch``) of a meta input."""
    spec = shd.resolve_spec(x.shape[:1], ("batch",), mesh, rules)
    return torch.empty(shd.local_shape(x.shape, spec, mesh), dtype=x.dtype,
                       device="meta")


def cell_inputs(cfg, shape, mesh, rules) -> list:
    """Rank 0's inputs of a cell's step on ``mesh`` under ``rules``, on
    the meta device: the parameters ``param_axes`` gives laid out as its
    blocks (a ``sharding.LaidOutTree``), then for ``train`` the AdamW
    state of those blocks and its rows of the batch, for ``prefill`` its
    rows of the batch, for ``decode`` its rows of the ids, the cache
    ``init_cache(..., mesh=)`` lays out and the filled length."""
    p_meta, p_axes = zoo.param_axes(cfg)
    specs = ly.axes_to_specs(p_meta, p_axes, mesh, rules)
    tree = shd.LaidOutTree(_blocks(p_meta, specs, mesh), specs, mesh, rules)
    if shape.kind == "decode":
        toks, _, cache_len = ss.decode_input_specs(cfg, shape.seq_len,
                                                   shape.global_batch)
        cache = zoo.init_cache(cfg, shape.global_batch, shape.seq_len,
                               device="meta", mesh=mesh, rules=rules)
        return [tree, _rows(toks, mesh, rules), cache, cache_len]
    batch = ts.input_specs(cfg, shape.seq_len, shape.global_batch,
                           shape.kind)
    rows = {k: _rows(v, mesh, rules) for k, v in batch.items()}
    if shape.kind == "train":
        return [tree, opt.init(tree), rows]
    return [tree, rows]


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               microbatch: int = 1, fsdp: bool = True,
               remat: str = "block", compress=None, kv_dtype=None,
               param_dtype=None, probe_layers=None):
    """Returns ``(step, meta, cfg, shape)``: ``step()`` runs rank 0's
    step of the cell on the meta device (:func:`cell_inputs`) and
    returns its outputs.  The reference's options: ``microbatch``,
    ``remat`` (set on the config, as the reference sets it) and
    ``compress`` act on a train cell."""
    cfg = registry.get(arch)
    if remat != cfg.remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    if param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    if probe_layers is not None:
        cfg = _probe_cfg(cfg, probe_layers)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = cell_rules(cfg, shape, mesh, multi_pod, fsdp)
    args = cell_inputs(cfg, shape, mesh, rules)
    if shape.kind == "train":
        fn = ts.make_train_step(cfg, microbatch=microbatch,
                                compress=compress)
    elif shape.kind == "prefill":
        fn = ss.make_prefill(cfg)
    else:
        fn = ss.make_decode_step(cfg)

    def step():
        with torch.set_grad_enabled(shape.kind == "train"):
            return fn(*args)

    meta = {"arch": arch, "shape": shape_name,
            "mesh": "multi" if multi_pod else "single",
            "n_devices": 512 if multi_pod else 256,
            "kind": shape.kind, "seq_len": shape.seq_len,
            "global_batch": shape.global_batch,
            "n_params": cfg.n_params(),
            "n_active_params": cfg.n_active_params(),
            "microbatch": microbatch, "fsdp": fsdp, "remat": remat,
            "compress": compress,
            "rules": {k: list(v) for k, v in rules.items()
                      if k in SEQ_NAMES and v},
            "argument_bytes": _nbytes(args)}
    return step, meta, cfg, shape


def count(step) -> dict:
    """One meta run of ``step`` under the three counters: ``flops``
    (matmul-class), ``bytes`` (aten ops' inputs and outputs), ``wire``
    (the collectives' ring-model bytes), ``collectives`` (by kind)."""
    t0 = time.time()
    fc = FlopCounterMode(display=False)
    ob = OpBytes()
    with cl.recording() as rec, fc, ob:
        step()
    colls = rf.tally(rec)
    return {"run_s": round(time.time() - t0, 3),
            "flops": float(fc.get_total_flops()), "bytes": float(ob.total),
            "aten_ops": ob.ops,
            "wire": float(sum(c["wire_bytes"] for c in colls.values())),
            "collectives": colls}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             tag: str = "", probes: bool = True, **kw):
    """The full-depth run (its collectives, its argument bytes) plus,
    with ``probes``, the 1-unit and 2-unit runs whose difference gives
    the per-unit flops, bytes and wire bytes, extrapolated to the depth
    as the reference does.  Writes ``{arch}__{shape}__{mesh}{tag}.json``
    under ``out_dir`` (when given) and prints the roofline line."""
    t0 = time.time()
    step, meta, cfg, shape = lower_cell(arch, shape_name, multi_pod, **kw)
    t_lower = time.time() - t0
    full = count(step)
    meta.update({
        "lower_s": round(t_lower, 3), "compile_s": 0.0,
        "count_s": full["run_s"],
        "memory_analysis": {
            "argument_size_in_bytes": meta.pop("argument_bytes"),
            "note": "rank 0's parameters, AdamW state, inputs and "
                    "cache; temporaries are not counted"},
        "collectives_fullscan": full["collectives"],
        "hlo_bytes": 0,
        "counted_by": "a meta-device run of rank 0's step: "
                      "FlopCounterMode (matmul-class flops), aten ops' "
                      "input and output bytes, collectives.recording()",
    })
    if probes:
        u = probe_unit(cfg)
        kw.pop("probe_layers", None)
        p1 = count(lower_cell(arch, shape_name, multi_pod, probe_layers=u,
                              **kw)[0])
        p2 = count(lower_cell(arch, shape_name, multi_pod,
                              probe_layers=2 * u, **kw)[0])
        n_units = cfg.n_layers / u
        flops = p1["flops"] + (n_units - 1) * (p2["flops"] - p1["flops"])
        bytes_acc = p1["bytes"] + (n_units - 1) * (p2["bytes"] - p1["bytes"])
        wire = p1["wire"] + (n_units - 1) * (p2["wire"] - p1["wire"])
        meta["probe"] = {
            "unit": u, "l1": p1, "l2": p2,
            "per_unit_flops": p2["flops"] - p1["flops"],
            "per_unit_bytes": p2["bytes"] - p1["bytes"],
            "per_unit_wire": p2["wire"] - p1["wire"],
        }
    else:
        flops, bytes_acc, wire = full["flops"], full["bytes"], full["wire"]

    terms = rf.roofline_terms(flops, bytes_acc, wire)
    mflops = rf.model_flops(cfg, shape.seq_len, shape.global_batch,
                            shape.kind)
    global_flops = flops * meta["n_devices"]
    meta.update({
        "flops_per_device": flops, "bytes_per_device": bytes_acc,
        "wire_bytes_per_device": wire, "roofline": terms,
        "model_flops": mflops,
        "useful_flops_ratio": (mflops / global_flops
                               if global_flops else 0.0),
    })
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{arch}__{shape_name}__{meta['mesh']}{tag}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(meta, f, indent=1)
    print(rf.summarize(meta))
    print(f"  lower={t_lower:.1f}s count={meta['count_s']:.1f}s "
          f"mem={meta['memory_analysis']['argument_size_in_bytes']} B "
          f"rules={meta['rules']} "
          f"colls={ {k: v['count'] for k, v in full['collectives'].items()} }")
    return meta


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--remat", default="block")
    ap.add_argument("--compress", default=None)
    ap.add_argument("--kv-dtype", default=None)
    ap.add_argument("--param-dtype", default=None)
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--list-cells", action="store_true")
    args = ap.parse_args(argv)

    if args.list_cells:
        for a, s in cells():
            print(a, s)
        return
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for mp in meshes:
        run_cell(args.arch, args.shape, mp, args.out, tag=args.tag,
                 probes=not args.no_probes,
                 microbatch=args.microbatch, fsdp=not args.no_fsdp,
                 remat=args.remat, compress=args.compress,
                 kv_dtype=args.kv_dtype, param_dtype=args.param_dtype)


if __name__ == "__main__":
    main()

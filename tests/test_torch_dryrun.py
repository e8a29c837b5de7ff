"""The port's dry-run tooling (``repro_torch.launch``: ``mesh``,
``roofline``, ``dryrun``, ``gen_table``) against the JAX package's.

The reference's ``launch/dryrun.py`` forces 512 placeholder devices
when it is imported, so it is imported only in a subprocess: this
file's own ``__main__``, which lists its cells and captures the rules
its ``lower_cell`` builds for every (cell, mesh) pair (its
``default_rules`` kept, its ``build_params`` stopped, its production
mesh a ``jax.sharding.AbstractMesh``), with the parameter, cache and
batch specs its ``axes_to_specs``/``resolve_spec`` give under them.
The port's ``cells``, ``cell_rules`` and specs must equal them; its
ring model must equal ``parse_collectives`` on HLO lines of each kind
and group size; ``roofline_terms`` (the reference's constants swapped
for the port's), ``model_flops`` and ``build_table`` must equal the
reference's.  One meta dry-run of a real cell runs in-process.
"""

import contextlib
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return tuple(tree)


def _reference_main(out_path: str) -> None:
    """The reference's cells, rules and specs, pickled to ``out_path``."""
    from repro.launch import dryrun as rd      # sets XLA_FLAGS first
    import jax
    from repro.configs import registry
    from repro.configs.base import SHAPES
    from repro.models.layers import axes_to_specs
    from repro.train import train_step as jts

    build = rd.zoo.build_params
    default_rules = rd.shd.default_rules
    kept = []

    class Stop(Exception):
        pass

    def keep(*a, **kw):
        kept.append(default_rules(*a, **kw))
        return kept[-1]

    def stop(*a, **kw):
        raise Stop

    def abstract(multi_pod=False):
        if multi_pod:
            return jax.sharding.AbstractMesh((2, 16, 16),
                                             ("pod", "data", "model"))
        return jax.sharding.AbstractMesh((16, 16), ("data", "model"))

    jitted = []

    def capture(fn, in_shardings=None, **kw):
        jitted.append(in_shardings)
        raise Stop

    rd.shd.default_rules = keep
    rd.zoo.build_params = stop
    rd.make_production_mesh = abstract
    rd.jax.jit = capture
    # the rules and the mesh reach the specs as arguments; an abstract
    # mesh cannot be entered
    rd.shd.use_mesh = lambda *a, **kw: contextlib.nullcontext()
    out = {"cells": rd.cells(), "pairs": {}, "train": {}}
    for arch, shape_name in out["cells"]:
        for mp in (False, True):
            kept.clear()
            # a train cell runs on to its jit, whose shardings are kept
            rd.zoo.build_params = build if shape_name == "train_4k" \
                else stop
            try:
                rd.lower_cell(arch, shape_name, mp)
            except Stop:
                pass
            rules = kept[-1]
            if shape_name == "train_4k":
                _, o_sh, b_sh = jitted.pop()
                spec = (lambda t: jax.tree.map(lambda s: tuple(s.spec), t))
                out["train"][arch, mp] = (
                    (tuple(o_sh.step.spec), spec(o_sh.mu), spec(o_sh.nu)),
                    spec(b_sh))
            mesh = abstract(mp)
            cfg, shape = registry.get(arch), SHAPES[shape_name]
            avals, axes = build(cfg, abstract=True)
            pspecs = _spec_tree(axes_to_specs(avals, axes, mesh, rules))
            cspecs = bspecs = None
            if shape.kind == "decode":
                c = rd.zoo.init_cache(cfg, shape.global_batch,
                                      shape.seq_len, abstract=True)
                cax = rd.zoo.cache_axes(cfg)
                cspecs = {k: tuple(rd.shd.resolve_spec(
                    v.shape, cax[k], mesh, rules)) for k, v in c.items()}
            else:
                b = jts.input_specs(cfg, shape.seq_len, shape.global_batch,
                                    shape.kind)
                bax = jts.batch_axes(cfg, shape.kind)
                bspecs = {k: tuple(rd.shd.resolve_spec(
                    v.shape, bax[k], mesh, rules)) for k, v in b.items()}
            out["pairs"][arch, shape_name, mp] = (
                {k: (tuple(v) if v else v) for k, v in rules.items()},
                pspecs, cspecs, bspecs)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "dryrun.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, __file__, str(out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def test_cells_equal_the_reference_list(reference):
    """``cells()`` is the reference's ``--list-cells``: 32 pairs, the
    ``long_500k`` cells of the sub-quadratic archs only."""
    from repro_torch.launch import dryrun
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "repro.launch.dryrun",
                        "--list-cells"], env=env, capture_output=True,
                       text=True, timeout=300)
    listed = [tuple(line.split()) for line in r.stdout.strip().splitlines()]
    assert dryrun.cells() == listed == list(reference["cells"])
    assert len(listed) == 32


@pytest.mark.parametrize("multi_pod", (False, True))
def test_cell_rules_and_specs_equal_the_reference(reference, multi_pod):
    """On every cell of one production mesh: the port's ``cell_rules``
    equal the rules the reference's ``lower_cell`` builds, and the
    parameter, cache (decode) and batch (train, prefill) specs the
    port resolves under them equal the reference's on a
    ``jax.sharding.AbstractMesh``; the four sequence names are on where
    the reference turns them on."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import layers as ly
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import train_step as ts
    mesh = make_production_mesh(multi_pod=multi_pod)
    seen = set()
    for (arch, shape_name, mp), (rules, ps, cs, bs) in \
            reference["pairs"].items():
        if mp != multi_pod:
            continue
        cfg, shape = registry.get(arch), SHAPES[shape_name]
        got = dryrun.cell_rules(cfg, shape, mesh, multi_pod)
        assert got == rules, (arch, shape_name)
        seen |= {k for k in dryrun.SEQ_NAMES if got[k]}
        p, axes = zoo.param_axes(cfg)
        assert ly.axes_to_specs(p, axes, mesh, got) == ps, (arch, shape_name)
        if cs is not None:
            c = zoo.init_cache(cfg, shape.global_batch, shape.seq_len,
                               device="meta")
            cax = zoo.cache_axes(cfg)
            assert {k: shd.resolve_spec(v.shape, cax[k], mesh, got)
                    for k, v in c.items()} == cs, (arch, shape_name)
        else:
            b = ts.input_specs(cfg, shape.seq_len, shape.global_batch,
                               shape.kind)
            bax = ts.batch_axes(cfg, shape.kind)
            assert {k: shd.resolve_spec(v.shape, bax[k], mesh, got)
                    for k, v in b.items()} == bs, (arch, shape_name)
    assert seen == set(dryrun.SEQ_NAMES)


def _hlo(kind, shape, dtype, g):
    groups = (f"replica_groups=[{64 // g if g > 1 else 64},{g}]<=[64]"
              if g in (4, 16) else
              "replica_groups={{" + ",".join(map(str, range(g))) + "}}")
    return (f"  %x = {dtype}[{','.join(map(str, shape))}]{{1,0}} {kind}("
            f"{dtype}[4,4]{{1,0}} %p), channel_id=1, {groups}")


@pytest.mark.parametrize("kind", ("all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"))
def test_wire_bytes_equal_parse_collectives(kind):
    """The ring model of each kind, on group sizes 1, 2, 4 and 16 (both
    of the HLO's group syntaxes) and two dtypes: the port's
    ``wire_bytes`` equals the reference's ``parse_collectives``, and
    ``tally`` sums the records as it does."""
    from repro.launch import roofline as jrf
    from repro_torch.launch import roofline as rf
    recs, lines = [], []
    for g in (1, 2, 4, 16):
        for dtype, nb in (("bf16", 2), ("f32", 4)):
            shape = (g * 3, 7)
            line = _hlo(kind, shape, dtype, g)
            want = jrf.parse_collectives(line)[kind]["wire_bytes"]
            size = nb * shape[0] * shape[1]
            assert rf.wire_bytes(kind, size, g) == want, (g, dtype)
            recs.append((kind, size, g))
            lines.append(line)
    assert rf.tally(recs) == jrf.parse_collectives("\n".join(lines))


def test_roofline_terms_equal_the_reference(monkeypatch):
    """``roofline_terms`` equals the reference's once its TPU constants
    are swapped for the port's H100 ones, on each dominant term."""
    from repro.launch import roofline as jrf
    from repro_torch.launch import mesh as tm
    from repro_torch.launch import roofline as rf
    monkeypatch.setattr(jrf, "PEAK_FLOPS_BF16", tm.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jrf, "HBM_BW", tm.HBM_BW)
    monkeypatch.setattr(jrf, "ICI_BW", tm.LINK_BW)
    assert tm.PEAK_FLOPS_BF16 == 989e12 and tm.HBM_BW == 3.35e12
    for f, b, w in ((1e15, 1e9, 1e6), (1e9, 1e13, 1e6), (1e9, 1e9, 1e13),
                    (0.0, 0.0, 0.0)):
        assert rf.roofline_terms(f, b, w) == jrf.roofline_terms(f, b, w)


def test_model_flops_equal_the_reference():
    """``model_flops`` of every arch, for each kind, at each shape."""
    from repro.configs import registry as jreg
    from repro.configs.base import SHAPES as JSHAPES
    from repro.launch import roofline as jrf
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import roofline as rf
    assert SHAPES == {k: type(SHAPES[k])(*(getattr(v, f) for f in (
        "name", "seq_len", "global_batch", "kind")))
        for k, v in JSHAPES.items()}
    for arch in registry.ARCHS:
        for kind, shape in (("train", "train_4k"),
                            ("prefill", "prefill_32k"),
                            ("decode", "decode_32k")):
            s = SHAPES[shape]
            assert rf.model_flops(registry.get(arch), s.seq_len,
                                  s.global_batch, kind) == \
                jrf.model_flops(jreg.get(arch), s.seq_len, s.global_batch,
                                kind), (arch, kind)


@pytest.mark.parametrize("multi_pod", (False, True))
def test_train_state_and_batch_specs_equal_the_reference(reference,
                                                         multi_pod):
    """On every ``train_4k`` cell of one production mesh: the AdamW
    state's specs (``step`` replicated, ``mu`` and ``nu`` laid out like
    the parameters) and the batch's equal the shardings the reference's
    ``lower_cell`` hands its jit, and rank 0's inputs
    (``dryrun.cell_inputs``) are the blocks of those layouts."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.tree import leaves
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import train_step as ts
    mesh = make_production_mesh(multi_pod=multi_pod)
    shape = SHAPES["train_4k"]
    cells = [(a, mp) for a, mp in reference["train"] if mp == multi_pod]
    assert len(cells) == 10
    for arch, _ in cells:
        (step, mu, nu), bspecs = reference["train"][arch, multi_pod]
        cfg = registry.get(arch)
        rules = dryrun.cell_rules(cfg, shape, mesh, multi_pod)
        tree, state, rows = dryrun.cell_inputs(cfg, shape, mesh, rules)
        assert step == () and state.step.shape == (), arch
        assert isinstance(state.mu, shd.LaidOutTree), arch
        assert _spec_tree(state.mu.specs) == _spec_tree(mu), arch
        assert _spec_tree(state.nu.specs) == _spec_tree(nu), arch
        p_meta, _ = zoo.param_axes(cfg)
        for m, w, sp in zip(leaves(state.mu), leaves(p_meta),
                            shd.spec_leaves(state.mu.specs)):
            assert m.dtype == torch.float32 and tuple(m.shape) == \
                shd.local_shape(w.shape, sp, mesh), arch
        batch = ts.input_specs(cfg, shape.seq_len, shape.global_batch)
        assert sorted(rows) == sorted(bspecs) == sorted(batch), arch
        for k, v in batch.items():
            assert tuple(rows[k].shape) == shd.local_shape(
                v.shape, bspecs[k], mesh), (arch, k)


def test_meta_train_cell_counts_the_backward_and_the_remat():
    """qwen2-0.5b ``train_4k``'s 1-layer probe on the single mesh: the
    whole step's matmul flops are 3x the same cell's forward (the loss)
    within 2% with remat off, between 3x and 4x with block remat (the
    blocks' forward again); its collectives include the backward's
    transposes; its argument bytes count the AdamW state."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.tree import leaves
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import train_step as ts
    step, meta, cfg, shape = dryrun.lower_cell(
        "qwen2-0.5b", "train_4k", False, probe_layers=1, remat="none")
    mesh = make_production_mesh()
    tree, state, rows = dryrun.cell_inputs(
        cfg, SHAPES["train_4k"], mesh,
        dryrun.cell_rules(cfg, shape, mesh, False))

    def forward():
        with torch.no_grad():
            ts.loss_fn(tree, cfg, rows)
    fwd = dryrun.count(forward)
    off = dryrun.count(step)
    on = dryrun.count(dryrun.lower_cell("qwen2-0.5b", "train_4k", False,
                                        probe_layers=1)[0])
    assert abs(off["flops"] / fwd["flops"] - 3) <= 0.06
    assert 3 < on["flops"] / fwd["flops"] < 4
    assert meta["remat"] == "none" and meta["rules"] == {
        "cp_seq": ["model"], "cp_q": ["model"]}
    for kind in ("all-gather", "reduce-scatter"):
        assert off["collectives"][kind]["count"] > \
            fwd["collectives"][kind]["count"], kind
    assert meta["argument_bytes"] == dryrun._nbytes([tree, state, rows])
    assert dryrun._nbytes(state) == 2 * sum(
        4 * p.numel() for p in leaves(tree)) + 4


def test_dryrun_all_sweeps_the_64_pairs(tmp_path, capsys):
    """``dryrun_all`` runs every (cell, mesh) pair, the 20 ``train_4k``
    ones included: with each pair's JSON present it skips all 64."""
    from repro_torch.launch import dryrun, dryrun_all
    pairs = dryrun_all.pairs("both")
    assert len(pairs) == 64 == 2 * len(dryrun.cells())
    assert sum(s == "train_4k" for _, s, _ in pairs) == 20
    for arch, shape, mesh in pairs:
        (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text("{}")
    out = dryrun_all.main(["--out", str(tmp_path)])
    assert out == {"done": [], "skipped": pairs}


def test_meta_dry_run_of_a_decode_cell(tmp_path):
    """qwen2-0.5b ``decode_32k`` on the single mesh, counted on the meta
    device in this process: the flash-decoding layout (kvseq over
    model, 2 kv heads on 16 ranks) and its traffic, five all-reduces a
    layer (the combine's max and two sums, the attention's and the
    MLP's row-parallel sums);
    rank 0's argument bytes; the JSON under the reference's name and
    keys, which both packages' ``build_table`` read alike."""
    from repro.launch import gen_table as jgt
    from repro_torch.launch import dryrun, gen_table
    meta = dryrun.run_cell("qwen2-0.5b", "decode_32k", False, str(tmp_path))
    assert meta["rules"] == {"kvseq": ["model"]}
    ar = meta["probe"]["l2"]["collectives"]["all-reduce"]["count"] - \
        meta["probe"]["l1"]["collectives"]["all-reduce"]["count"]
    assert ar == 5
    assert meta["collectives_fullscan"]["all-reduce"]["count"] == 5 * 24 + 1
    assert meta["memory_analysis"]["argument_size_in_bytes"] > 0
    assert meta["flops_per_device"] > 0 and meta["bytes_per_device"] > 0
    with open(tmp_path / "qwen2-0.5b__decode_32k__single.json") as f:
        d = json.load(f)
    for k in ("arch", "shape", "mesh", "n_devices", "kind", "seq_len",
              "global_batch", "n_params", "n_active_params", "lower_s",
              "compile_s", "memory_analysis", "collectives_fullscan",
              "probe", "flops_per_device", "bytes_per_device",
              "wire_bytes_per_device", "roofline", "model_flops",
              "useful_flops_ratio"):
        assert k in d, k
    # a second single-mesh cell and a multi-mesh one, written by hand
    for name, arch, shape, dom in (("a__prefill_32k__single", "a",
                                    "prefill_32k", "memory"),
                                   ("a__prefill_32k__multi", "a",
                                    "prefill_32k", "compute")):
        with open(tmp_path / f"{name}.json", "w") as f:
            json.dump({"arch": arch, "shape": shape, "roofline": {
                "compute_s": 1.5e-3, "memory_s": 2.5e-2,
                "collective_s": 3e-4, "dominant": dom},
                "useful_flops_ratio": 0.5, "memory_analysis": {
                    "argument_size_in_bytes": 123456789,
                    "temp_size_in_bytes": 1000}}, f)
    assert gen_table.build_table(str(tmp_path)) == \
        jgt.build_table(str(tmp_path))
    md = tmp_path / "table.md"
    md.write_text("# head\n\n<!-- ROOFLINE_TABLE -->\nold\n")
    gen_table.main([str(tmp_path), str(md)])
    gen_table.main([str(tmp_path), str(md)])
    assert md.read_text() == ("# head\n\n<!-- ROOFLINE_TABLE -->\n\n"
                              + jgt.build_table(str(tmp_path)) + "\n")


def test_collectives_on_meta_record_and_call_nothing():
    """On a rank of an ``AbstractMesh`` the collectives take meta
    tensors without a process group: shaped results, and one record
    each of its kind, bytes and group size."""
    import torch

    from repro_torch.parallel import collectives as cl
    from repro_torch.parallel import sharding as shd
    mesh = shd.AbstractMesh({"data": 2, "model": 4})
    x = torch.empty((8, 6), dtype=torch.bfloat16, device="meta")
    with cl.recording() as rec:
        assert cl.all_gather(x, mesh).shape == (4, 8, 6)
        assert cl.psum(x, mesh, axis="data").dtype == torch.bfloat16
        assert cl.reduce_scatter(x, mesh, dim=0).shape == (2, 6)
        assert cl.pmax(x, mesh).shape == (8, 6)
        assert cl.all_to_all(x, mesh).shape == (8, 6)
        cl.psum(x, shd.AbstractMesh({"data": 1, "model": 1}))
    assert rec == [("all-gather", 384, 4), ("all-reduce", 192, 2),
                   ("reduce-scatter", 48, 4), ("all-reduce", 96, 4),
                   ("all-to-all", 96, 4)]
    assert np.isclose(sum(s for _, s, _ in rec), 816)


COLLECTIVES = {
    "all_gather": lambda cl, x, m: cl.all_gather(x, m),
    "psum": lambda cl, x, m: cl.psum(x, m),
    "pmax": lambda cl, x, m: cl.pmax(x, m),
    "reduce_scatter": lambda cl, x, m: cl.reduce_scatter(x, m),
    "all_to_all": lambda cl, x, m: cl.all_to_all(x, m),
    "ppermute": lambda cl, x, m: cl.ppermute(x, m, "model", [(0, 1)]),
}


@pytest.mark.parametrize("kind", sorted(COLLECTIVES))
def test_collectives_refuse_real_tensors_on_an_abstract_mesh(kind):
    """An ``AbstractMesh`` has no process group: a collective over one
    of its axes of more than one rank on a CPU tensor raises instead of
    calling the default group, and nothing is recorded; over an axis of
    one rank it is the identity."""
    import torch

    from repro_torch.parallel import collectives as cl
    from repro_torch.parallel import sharding as shd
    x = torch.ones((4, 2))
    with cl.recording() as rec:
        with pytest.raises(ValueError, match="no process group"):
            COLLECTIVES[kind](cl, x, shd.AbstractMesh({"data": 1,
                                                       "model": 4}))
    assert rec == []
    if kind != "ppermute":
        COLLECTIVES[kind](cl, x, shd.AbstractMesh({"data": 1, "model": 1}))
    with pytest.raises(ValueError, match="no process group"):
        shd.AbstractMesh({"model": 4}).axis_group("model")


if __name__ == "__main__":
    _reference_main(sys.argv[1])

"""The sharded train step against the JAX package's meshless one.

The port's step on a ``sharding.LaidOutTree`` (``train.train_step``:
the loss over a rank's vocab block and stream block, the gradients from
the differentiable collectives and their transposes, each leaf's shares
summed over the axes its spec does not split, AdamW and the compression
on blocks) runs on gloo worlds of 2 and 4 CPU ranks
(``mesh_cases.train_mesh_rank``, both worlds launched together) while
the JAX side runs here, jitted, once for the module.  The cases are
``mesh_cases.TRAIN_CASES``: the dense smoke (qwen2-0.5b, tied
embeddings) with whole heads on 1 x 2, under ``cp_seq`` + ``cp_q`` on
1 x 4 and with fsdp and the batch over ``data`` on 2 x 2; whisper and
paligemma on 1 x 2; phi's experts and zamba2 on 1 x 4; two
microbatches of a batch whose labels hold -1 inside rows on 2 x 2; int8
and top-k compression.  The parameters and the batch are
``tests/test_torch_train.py``'s (the JAX package's weights), and so are
the tolerances: the loss and ``grad_norm`` at rtol 1e-4, atol 1e-5, each
leaf's gradient (gathered whole) elementwise, or norm-wise where that
test's ``NORMWISE`` names the leaf, or by its float64 witness where
``WITNESSED`` does (that test's, and paligemma's ``embed``, which misses
norm-wise here; at most twice as far from the JAX package's float64
gradients as JAX's float32).  AdamW divides by the gradient's own scale,
so the new parameters and moments are held norm-wise, or by the float64
witness (AdamW of the witness gradients) where their gradient or the
clipping norm is witnessed; and each rank's blocks of them must equal
the meshless port's AdamW (with the compression) applied to the
gathered gradients (rtol 1e-6).  Under compression, as in ``test_torch_train.py``, the
loss and ``grad_norm`` are held against the JAX step.  A leaf's
gradient blocks are bit-equal on every rank that holds the same block.

Each differentiable collective passes the transpose identity
``sum_r <ct_r, f(x)_r> = sum_r <f^T(ct)_r, x_r>`` over every axis of
1 x 2, 1 x 4 and 2 x 2, in float64 and in bfloat16 (small integers,
exact in both), and on the meta device records its backward's
collective.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_cases as mc
import test_torch_train as tt
from repro.configs import registry
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.parallel import collectives as cl
from repro_torch.parallel import compression as tcomp
from repro_torch.parallel import sharding as shd
from repro_torch.train import optimizer as topt

CASES = {c[0]: c for c in mc.TRAIN_CASES}
WORLDS = {"1x2": 2, "1x4": 4, "2x2": 4}
# test_torch_train.py's witnessed leaves, and the one leaf whose sharded
# gradient misses norm-wise too (readings: the assertion's excess, 1.09)
WITNESSED = dict(tt.WITNESSED, **{"paligemma-3b": {"embed"}})


def _jax_ref(arch, microbatch, compress):
    """The JAX package's step from ``tests/test_torch_train.py``'s
    parameters on ``mesh_cases.train_batch_of``, jitted: ``(grads, new
    params, state, metrics)`` as numpy, the gradients (the mean of the
    microbatches' gradients) computed beside the step (none under
    compression)."""
    cfg, params = tt._models(arch)[:2]
    batch = jax.tree.map(jnp.asarray, mc.train_batch_of(
        registry.get_smoke(arch), microbatch))
    step = jts.make_train_step(cfg, microbatch=microbatch,
                               compress=compress)
    grad = jax.grad(jts.loss_fn)

    def run(p, b):
        out = step(p, jopt.init(p), b)
        if compress is not None:
            return None, out
        parts = [jax.tree.map(lambda x, i=i: x.reshape(
            microbatch, -1, *x.shape[1:])[i], b) for i in range(microbatch)]
        gs = [grad(p, cfg, part) for part in parts]
        return jax.tree.map(lambda *g: sum(g) / microbatch, *gs), out
    g, out = jax.jit(run)(params, batch)
    flat = (lambda t: tt._flat(jax.tree.map(np.asarray, t)))
    return {"grads": None if g is None else flat(g), "params": flat(out[0]),
            "mu": flat(out[1].mu), "nu": flat(out[1].nu),
            "step": int(out[1].step),
            "loss": float(out[2]["loss"]),
            "grad_norm": float(out[2]["grad_norm"])}


def _witness_update(arch, w64):
    """AdamW's first step in float64 from the JAX parameters and the
    float64 witness gradients ``w64`` (``_jax_witness``): the witness of
    the new parameters and moments."""
    params = tt._flat(jax.tree.map(np.asarray, tt._models(arch)[1]))
    s = min(1.0, 1.0 / max(w64["grad_norm"], 1e-9))
    out = {"params": {}, "mu": {}, "nu": {}}
    for k, p in params.items():
        g = w64[k] * s
        p = p.astype(np.float64)
        out["mu"][k], out["nu"][k] = 0.1 * g, 0.05 * g * g
        out["params"][k] = p - 3e-4 * (g / (np.abs(g) + 1e-8) + 0.1 * p)
    return out


@pytest.fixture(scope="module")
def runs():
    """The port's worlds of 2 and 4 ranks and, while they run, the JAX
    references: ``(ranks {S: per-rank results}, ref {case: ...})``."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch import spmd
    archs = sorted({c[1] for c in mc.TRAIN_CASES})
    params_np = {a: jax.tree.map(np.asarray, tt._models(a)[1])
                 for a in archs}
    with ThreadPoolExecutor(2) as ex:
        worlds = {S: ex.submit(spmd.spawn, mc.train_mesh_rank, S,
                               params_np, device="cpu", threads=1,
                               timeout=600) for S in (2, 4)}
        ref, seen = {}, {}
        for name, (_, arch, _, _, mb, comp) in CASES.items():
            key = (arch, mb, comp)
            if key not in seen:
                seen[key] = _jax_ref(arch, mb, comp)
            ref[name] = seen[key]
        for arch in WITNESSED:
            if arch in archs:
                w64 = tt._jax_witness(arch)
                ref[arch, "w64"] = (w64, _witness_update(arch, w64))
        return {S: f.result() for S, f in worlds.items()}, ref


def _case(runs, name):
    ranks = runs[0][WORLDS[CASES[name][2]]]
    return [r["cases"][name] for r in ranks], runs[1][name]


def _keys(arch):
    return sorted(tt._flat(jax.tree.map(np.asarray, tt._models(arch)[1])))


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[5] is None])
def test_sharded_step_matches_jax(runs, name):
    """The loss, ``grad_norm`` and every leaf's gradient, new parameter
    and moments of every rank (gathered whole) against the JAX meshless
    step, under ``tests/test_torch_train.py``'s rules; ``step`` 1."""
    arch = CASES[name][1]
    per_rank, want = _case(runs, name)
    wit = WITNESSED.get(arch, set())
    w64, u64 = runs[1].get((arch, "w64"), (None, None))
    keys = _keys(arch)
    for r, got in enumerate(per_rank):
        msg = f"{name} rank {r}"
        tt._close(got["loss"], want["loss"], msg + " loss")
        tt._close(got["m_loss"], want["loss"], msg + " step loss")
        if "grad_norm" in wit:
            tt._witnessed(got["grad_norm"], want["grad_norm"],
                          w64["grad_norm"], msg + " grad_norm")
        else:
            tt._close(got["grad_norm"], want["grad_norm"],
                      msg + " grad_norm")
        assert got["step"] == want["step"] == 1
        for i, k in enumerate(keys):
            g = got["grads"][i]
            if k in wit:
                tt._witnessed(g, want["grads"][k], w64[k], (msg, k))
            elif k in tt.NORMWISE.get(arch, ()):
                assert tt._norm_excess(g, want["grads"][k]) <= 1.0, (msg, k)
            else:
                assert tt._excess(g, want["grads"][k]) <= 1.0, (msg, k)
            for part in ("params", "mu", "nu"):
                if k in wit or "grad_norm" in wit:
                    tt._witnessed(got[part][i], want[part][k],
                                  u64[part][k], (msg, part, k))
                else:
                    assert tt._norm_excess(got[part][i],
                                           want[part][k]) <= 1.0, \
                        (msg, part, k)


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[5] is not None])
def test_compressed_sharded_step_matches_jax(runs, name):
    """Under int8 and top-k compression: the loss and ``grad_norm`` of
    every rank against the JAX step (as ``test_torch_train.py`` holds
    the meshless step)."""
    per_rank, want = _case(runs, name)
    for r, got in enumerate(per_rank):
        tt._close(got["m_loss"], want["loss"], f"{name} rank {r} loss")
        tt._close(got["grad_norm"], want["grad_norm"],
                  f"{name} rank {r} grad_norm")


@pytest.mark.parametrize("name", sorted(CASES))
def test_blocks_update_as_the_whole(runs, name):
    """Each rank's new parameters, moments (and error feedback's
    effect) gathered whole equal the meshless port's compression and
    AdamW applied to the gathered gradients and the whole parameters;
    the step's outputs stay laid out."""
    _, arch, _, _, _, comp = CASES[name]
    per_rank, _ = _case(runs, name)
    keys = _keys(arch)
    params = tt._flat(jax.tree.map(np.asarray, tt._models(arch)[1]))
    p = {k: torch.tensor(params[k]) for k in keys}
    for r, got in enumerate(per_rank):
        assert all(got["is_laid_out"]), (name, r)
        g = {k: torch.tensor(got["grads"][i]) for i, k in enumerate(keys)}
        if comp is not None:
            g, _ = tcomp.compress_decompress(g, None, mode=comp)
        new, state = topt.update(g, topt.init(p), p)
        for i, k in enumerate(keys):
            for part, want in (("params", new), ("mu", state.mu),
                               ("nu", state.nu)):
                tt._close(got[part][i], want[k].numpy(), (name, r, part, k),
                          **tt.OPT_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradient_blocks_equal_across_replicas(runs, name):
    """Ranks that hold the same block of a leaf (the same coordinates on
    the axes its spec splits) hold bit-equal gradients: a replicated
    leaf's gradient is the same on every rank."""
    mesh = CASES[name][2]
    ranks = runs[0][WORLDS[mesh]]
    per_rank = [r["cases"][name] for r in ranks]
    for i, spec in enumerate(per_rank[0]["specs"]):
        axes = shd.spec_axes(spec)
        groups = {}
        for r, got in zip(ranks, per_rank):
            c = r["coords"][mesh]
            groups.setdefault(tuple(c[a] for a in axes), []).append(
                got["blocks"][i])
        for blocks in groups.values():
            for b in blocks[1:]:
                np.testing.assert_array_equal(b, blocks[0], err_msg=str(
                    (name, i, spec)))


@pytest.mark.parametrize("mesh,dtype", list(itertools.product(
    ("1x2", "1x4", "2x2"), ("float64", "bfloat16"))))
def test_collectives_transpose_identity(runs, mesh, dtype):
    """``sum_r <ct_r, f(x)_r> == sum_r <f^T(ct)_r, x_r>`` for every
    differentiable collective over every axis of the mesh, ``f^T(ct)``
    the backward pass; results in the operand's dtype."""
    ranks = runs[0][WORLDS[mesh]]
    keys = [k for k in ranks[0]["transpose"] if k[0] == mesh
            and k[3] == dtype]
    assert len(keys) == len(mc.TRANSPOSE_KINDS) * (1 if mesh[0] == "1"
                                                   else 2)
    for k in keys:
        lhs = sum(r["transpose"][k][0] for r in ranks)
        rhs = sum(r["transpose"][k][1] for r in ranks)
        assert lhs == pytest.approx(rhs, rel=1e-12, abs=1e-12), k
        assert ranks[0]["transpose"][k][2:] == (f"torch.{dtype}",) * 2, k


@pytest.mark.parametrize("kind", mc.TRANSPOSE_KINDS)
def test_meta_backward_records_the_transpose(kind):
    """On an ``AbstractMesh`` (meta tensors) a collective's backward
    records its transpose's kind after the forward's."""
    mesh = shd.AbstractMesh({"data": 1, "model": 4})
    x = torch.empty((4, 8), device="meta", requires_grad=True)
    fns = {"all_gather": lambda x: cl.all_gather(x, mesh),
           "all_gather_tiled": lambda x: cl.all_gather_tiled(x, mesh),
           "psum": lambda x: cl.psum(x, mesh),
           "reduce_scatter_0": lambda x: cl.reduce_scatter(x, mesh, dim=0),
           "reduce_scatter_1": lambda x: cl.reduce_scatter(x, mesh, dim=1),
           "all_to_all": lambda x: cl.all_to_all(x, mesh),
           "ppermute": lambda x: cl.ppermute(x, mesh, "model",
                                             [(0, 1), (1, 0)])}
    back = {"all_gather": "reduce-scatter", "all_gather_tiled":
            "reduce-scatter", "psum": "all-reduce", "reduce_scatter_0":
            "all-gather", "reduce_scatter_1": "all-gather",
            "all_to_all": "all-to-all", "ppermute": "collective-permute"}
    fwd = {"all_gather": "all-gather", "all_gather_tiled": "all-gather",
           "reduce_scatter_0": "reduce-scatter",
           "reduce_scatter_1": "reduce-scatter"}.get(kind, back[kind])
    with cl.recording() as rec:
        y = fns[kind](x)
        g, = torch.autograd.grad(y, x, torch.empty_like(y))
    assert g.shape == x.shape and g.is_meta
    assert [r[0] for r in rec] == [fwd, back[kind]]
    assert all(r[2] == 4 for r in rec)
    with cl.recording() as rec, torch.no_grad():
        fns[kind](x)
    assert len(rec) == 1

"""The sequence layouts of the models on a mesh against the JAX
package's meshless functions: the rule sets the dry-run turns on
(``launch.dryrun.cell_rules``), each over more than one rank.

* ``cp_seq`` on ``1 x 4`` (Megatron-SP: the residual stream a block of
  positions a rank, gathered at each block's entry, reduce-scattered at
  its exit) and ``cp_seq`` with ``cp_q`` (a rank's block of q positions
  against the whole k/v), forward;
* ``kvseq`` over ``model`` on ``1 x 4`` (flash-decoding: a rank's block
  of the cache's positions), three decode steps of which the second
  writes the first position of rank 1's block, the int8 cache too;
* ``seq``/``kvseq`` over ``data`` on ``2 x 2`` with a global batch of 1
  (``default_rules(seq_sharded=True)``), forward and decode; zamba2's
  shared cache splits there.

Each family smoke of ``mesh_cases.FAMILY_ARCHS``, the dense
``minitron-8b`` and a dense smoke with 6 heads and 2 kv heads (which 4
ranks do not divide) run on one gloo world of 4 CPU ranks
(``mesh_cases.seq_layout_rank``) while the JAX side runs here.  The
forward is held stage by stage (each stage from the JAX state, read
through the JAX head) and its tapped logits at rtol 1e-4, atol 1e-5;
each decode step's logits the same way from the JAX cache before it,
or, where a logit misses, at most twice as far from the float64 step
as JAX's float32 (the port's meshless step in float64 from the same
cache); the rank's own cache chain gives the JAX greedy ids and, after
the last step, the JAX cache.  ``blockwise_attention`` with a small
``kv_chunk`` on a rank's q block equals the JAX pass's rows.  The
same world's ``collectives.reduce_scatter`` gives every rank its block
of the sum over each axis of both meshes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_cases as mc
from repro.configs import registry
from repro.models import attention as jattn
from repro.models import model_zoo as jzoo
from repro_torch.configs import registry as treg
from repro_torch.core.tree import tree_map
from repro_torch.models import model_zoo as zoo
from repro_torch.parallel import sharding as shd
from test_torch_model_mesh_families import _close_or_witnessed, _jax_stages

RTOL, ATOL = 1e-4, 1e-5
F32 = jnp.float32
MESHES = {"seq_data": {"data": 2, "model": 2}}


def _names():
    return sorted({n for _, n, _ in mc.SEQ_CASES})


# the reference's functions jitted (cfg static) take a third of the
# eager passes' time.  A jitted dict comes back in key order; the
# stages' order is kept from the trace.
_STAGE_ORDER = {}


def _traced_stages(params, cfg, toks, fr):
    stages, logits = _jax_stages(params, cfg, toks, fr)
    _STAGE_ORDER[cfg] = list(stages)
    return stages, logits


_JAX_STAGES = jax.jit(_traced_stages, static_argnums=(1,))
_JAX_STEP = jax.jit(jzoo.decode_step, static_argnums=(1,))


def _jax_decode(params, cfg, toks, max_seq):
    """The reference's decode steps from an empty cache through the last
    of ``SEQ_STEPS``: the cache before each step (and after the last),
    and each step's logits."""
    cache = jzoo.init_cache(cfg, toks.shape[0], max_seq)
    caches, steps = [], []
    for t in range(mc.SEQ_STEPS[-1] + 1):
        caches.append({k: np.asarray(v) for k, v in cache.items()})
        logits, cache = _JAX_STEP(
            params, cfg, jnp.asarray(toks[:, t:t + 1]), cache, jnp.int32(t))
        steps.append(np.asarray(logits))
    caches.append({k: np.asarray(v) for k, v in cache.items()})
    return caches, steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's world of 4 ranks, started first, and the JAX side
    computed here while it runs, published to the ranks as it is ready
    (parameters, stages, caches): ``(ranks, ref)``, ``ref`` holding each
    model's parameters, stages and logits, caches and decode steps for
    the batch of 2."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch import spmd
    d = str(tmp_path_factory.mktemp("seq"))
    names = _names()
    fwd = {n for _, n, p in mc.SEQ_CASES if p == "fwd"}
    dec = {n for _, n, p in mc.SEQ_CASES if p == "dec"}
    ref = {"params": {}, "np": {}, "fwd": {}, "dec": {}}
    with ThreadPoolExecutor(1) as ex:
        world = ex.submit(spmd.spawn, mc.seq_layout_rank, 4, d,
                          device="cpu", threads=1, timeout=900)
        for name in names:
            ref["np"][name] = tree_map(lambda t: t.numpy(), zoo.build_params(
                mc.seq_cfg(treg, name), seed=0, device="cpu"))
            ref["params"][name] = jax.tree.map(jnp.asarray, ref["np"][name])
        mc.write_pickle(f"{d}/params.pkl", ref["np"])
        for name in sorted(fwd):
            cfg = mc.seq_cfg(registry, name)
            toks, fr = mc.family_inputs(cfg)
            stages, logits = _JAX_STAGES(ref["params"][name], cfg, toks, fr)
            ref["fwd"][name] = ({k: np.asarray(stages[k])
                                 for k in _STAGE_ORDER[cfg]},
                                np.asarray(logits))
        mc.write_pickle(f"{d}/stages.pkl",
                        {n: v[0] for n, v in ref["fwd"].items()})
        for name in sorted(dec):
            cfg = mc.seq_cfg(registry, name)
            toks, _ = mc.family_inputs(cfg)
            ref["dec"][name] = _jax_decode(ref["params"][name], cfg, toks,
                                           mc.SEQ_CACHE["kvseq"])
        mc.write_pickle(f"{d}/caches.pkl",
                        {n: v[0] for n, v in ref["dec"].items()})
        q, k, v = (jnp.asarray(a) for a in mc.blockwise_inputs())
        ref["blockwise"] = {
            m: np.asarray(jattn.blockwise_attention(
                q, k, v, m, 5 if m == "prefix" else 0, kv_chunk=4))
            for m in mc.BLOCKWISE_CASES}
        return world.result(), ref


def _close(got, want, msg):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=msg)


def _step64(name, params_np, cache_np, toks, t):
    """The float64 witness of decode step ``t``: the port's meshless
    step in float64 (``card_checks.float64_mode``) from the JAX cache
    before it."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    from card_checks import as_float64, float64_mode

    from repro_torch.core import convert
    cfg = mc.seq_cfg(treg, name)
    p64 = as_float64(convert.params_from_numpy(params_np, device="cpu"))
    c64 = as_float64({k: torch.as_tensor(v) for k, v in cache_np.items()})
    with torch.no_grad(), float64_mode(torch):
        logits, _ = zoo.decode_step(
            p64, cfg, torch.as_tensor(toks[:, t:t + 1].astype(np.int64)),
            c64, t)
    return logits.numpy()


FWD = [c for c in mc.SEQ_CASES if c[2] == "fwd"]
DEC = [c for c in mc.SEQ_CASES if c[2] == "dec"]


@pytest.mark.parametrize("layout,name,part", FWD)
def test_forward_stages_match_jax(runs, layout, name, part):
    """Each stage of the forward under the layout, from the JAX state
    before it, gathered whole and read through the JAX head, and the
    tapped logits, on every rank; the stream is split where the layout
    says."""
    cfg = mc.seq_cfg(registry, name)
    params = runs[1]["params"][name]
    b = mc.seq_batch(layout)
    stages, logits = runs[1]["fwd"][name]
    stages, logits = mc.seq_slice(b, 0, stages=stages), logits[:b]
    for r, out in enumerate(runs[0]):
        res = out["cases"][layout, name, part]
        assert res["stream"] == (("data",) if layout == "seq_data"
                                 else ("model",)), r
        assert list(res["stages"]) == list(stages), r
        for k, x in res["stages"].items():
            _close(np.asarray(jzoo.logits_out(params, cfg, jnp.asarray(x),
                                              F32)),
                   np.asarray(jzoo.logits_out(params, cfg,
                                              jnp.asarray(stages[k]), F32)),
                   f"rank {r} stage {k}")
        _close(res["logits"], logits, f"rank {r} logits")


@pytest.mark.parametrize("layout,name,part", DEC)
def test_decode_steps_match_jax(runs, layout, name, part):
    """The decode steps under the layout, each from the JAX cache before
    it laid out, allclose to the JAX steps or held by the float64
    witness; the rank's own cache chain gives the JAX greedy ids and,
    after the last step, the JAX cache's first layer of ``k``; the
    cache's blocks split as ``cache_axes`` resolves, the positions over
    the layout's axis."""
    b = mc.seq_batch(layout)
    caches, steps = runs[1]["dec"][name]
    caches = [mc.seq_slice(b, mc.SEQ_CACHE[layout], cache=c) for c in caches]
    steps = [s[:b] for s in steps]
    toks, _ = mc.family_inputs(mc.seq_cfg(registry, name))
    toks = toks[:b]
    cfg = mc.seq_cfg(treg, name)
    am = shd.AbstractMesh(MESHES.get(layout, {"data": 1, "model": 4}))
    rules = mc.seq_rules(layout)
    tc = zoo.init_cache(cfg, b, mc.SEQ_CACHE[layout], device="meta")
    cax = zoo.cache_axes(cfg)
    for r, out in enumerate(runs[0]):
        res = out["cases"][layout, name, part]
        for j, t in enumerate(mc.SEQ_STEPS):
            _close_or_witnessed(
                res["dec"][j], steps[t],
                lambda: _step64(name, runs[1]["np"][name], caches[t], toks,
                                t), f"rank {r} step {t}")
            np.testing.assert_array_equal(res["free"][j],
                                          steps[t].argmax(-1))
        if "k" in caches[-1]:
            want = caches[-1]["k"][0].astype(np.float32)
            if cfg.kv_cache_dtype == "int8":
                assert np.abs(res["k_after"] - want).max() <= 1, r
            else:
                _close(res["k_after"], want, f"rank {r} cache")
            split = res["cache_specs"]["k"][2]
            assert split == ("data" if layout == "seq_data" else "model")
        for k, shape in res["cache_shapes"].items():
            spec = shd.resolve_spec(tc[k].shape, cax[k], am, rules)
            assert spec == res["cache_specs"][k], (k, r)
            assert shape == shd.local_shape(tc[k].shape, spec, am), (k, r)


@pytest.mark.parametrize("mask", mc.BLOCKWISE_CASES)
def test_blockwise_attention_on_q_blocks(runs, mask):
    """``blockwise_attention`` (kv_chunk 4) on each rank's block of 4 q
    positions of 16, its global offset in the mask, gathered whole,
    allclose to the JAX pass over all of q."""
    for r, out in enumerate(runs[0]):
        res = out["blockwise"][mask]
        assert res["axes"] == ("model",) and res["block"] == (4 * r, 4)
        _close(res["o"], runs[1]["blockwise"][mask], f"rank {r}")


@pytest.mark.parametrize("mesh_name", ["1x4", "2x2"])
def test_reduce_scatter_blocks_on_every_rank(runs, mesh_name):
    """``collectives.reduce_scatter`` over each axis of the mesh, along
    each dimension, in float32 and bfloat16: on every rank, its block
    of the sum over the ranks that differ from it on that axis only
    (the sum rounded once to the operand's dtype)."""
    outs = [out["reduce_scatter"] for out in runs[0]]
    coords = [o["coords"][mesh_name] for o in outs]
    shape = {"1x4": {"data": 1, "model": 4},
             "2x2": {"data": 2, "model": 2}}[mesh_name]
    for r, o in enumerate(outs):
        for axis, n in shape.items():
            group = [q for q, c in enumerate(coords)
                     if all(c[a] == coords[r][a] for a in shape if a != axis)]
            assert len(group) == n, (r, axis)
            for dim in (0, 1):
                for dt in mc.RS_DTYPES:
                    want = sum(mc.rs_input(q, "float32") for q in group)
                    size = want.shape[dim] // n
                    want = want.narrow(dim, coords[r][axis] * size, size)
                    got_dt, got = o[mesh_name, axis, dim, dt]
                    assert got_dt == f"torch.{dt}", (r, axis, dim)
                    np.testing.assert_array_equal(
                        got, want.to(getattr(torch, dt)).float().numpy(),
                        err_msg=f"rank {r} {mesh_name} {axis} {dim} {dt}")


def test_cases_cover_the_families():
    """Every family smoke and the two dense variants under each of the
    dry-run's four rule sets, and the int8 cache under kvseq."""
    for layout, part in (("cp_seq", "fwd"), ("cp_q", "fwd"),
                         ("kvseq", "dec"), ("seq_data", "fwd"),
                         ("seq_data", "dec")):
        got = {n for lo, n, p in mc.SEQ_CASES if (lo, p) == (layout, part)}
        assert set(mc.FAMILY_ARCHS) | {mc.DENSE_ARCH, mc.DENSE6} <= got
    assert ("kvseq", mc.DENSE_Q8, "dec") in mc.SEQ_CASES

"""The models on a mesh (the logical-axis layer, the models laid out
over ranks, ``Engine(mesh=...)``, the elastic re-lay) against the JAX
package.

Rules and specs are compared exactly with the JAX package's on
``jax.sharding.AbstractMesh`` meshes (no device mesh: ``jax.make_mesh``
gives Explicit axes on this jax, ROADMAP §C).  The port's sharded model
runs on gloo worlds of 2 and 4 CPU ranks (``launch.spmd.spawn``), one
launch a world for every case (``mesh_cases.model_mesh_rank``), against
the JAX package's meshless forward, decode steps and engine in this
process: the reference's engine hands its mesh to the pool only, and
its contract makes a meshless and a mesh engine equal.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mesh_cases as mc
from repro.configs import registry
from repro.models import layers as jly
from repro.models import model_zoo as jzoo
from repro.parallel import sharding as jshd
from repro.serve.engine import Engine, Request
from repro.train import elastic as jelastic
from repro_torch.configs import registry as treg
from repro_torch.models import layers as ly
from repro_torch.models import model_zoo as zoo
from repro_torch.parallel import sharding as shd
from repro_torch.train import elastic as telastic

MESHES = {"1x4": ((1, 4), ("data", "model")),
          "1x16": ((1, 16), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RTOL, ATOL = 1e-4, 1e-5


def _meshes(name):
    sizes, names = MESHES[name]
    return (jax.sharding.AbstractMesh(sizes, names),
            shd.AbstractMesh(dict(zip(names, sizes))))


def _spec_tree(t):
    if isinstance(t, dict):
        return {k: _spec_tree(v) for k, v in t.items()}
    return tuple(t)


# ---------------------------------------------------------------------------
# (a) the rule table and resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", list(itertools.product((False, True),
                                                         repeat=3)))
def test_default_rules_match_jax(flags):
    assert shd.default_rules(*flags) == jshd.default_rules(*flags)


RESOLVE_CASES = [
    # the reference's own cases (tests/test_sharding_launch.py)
    ((32, 64), ("batch", "mlp"), "1x1", None),
    ((32,), ("nope",), "1x1", None),
    ((4, 4), ("a", "b"), "1x1", {"a": ("data",), "b": ("data",)}),
    ((6, 4096), ("splay_level", "splay_width"), "1x1", None),
    ((6, 4096), ("splay_level", "splay_width"), "1x1",
     {"splay_level": None, "splay_width": ("expert_axis",)}),
    # indivisible: qwen2's 14 heads over 16, a kv head split over 4
    ((24, 896, 896), ("layers", "fsdp", "heads"), "1x16", None),
    ((24, 896, 128), ("layers", "fsdp", "kv"), "1x4", None),
    # two axes on one dimension, and the axis taken by an earlier one
    ((64, 128, 4096), ("batch", "seq", "embed"), "2x16x16", "multi_pod"),
    ((64, 48), ("batch", "fsdp"), "2x16x16", "multi_pod"),
    ((32, 32), ("mlp", "heads"), "16x16", None),
    ((3, 32), ("batch", "vocab"), "16x16", None),
    ((), (), "1x4", None),
]


@pytest.mark.parametrize("shape,names,mesh,rules", RESOLVE_CASES)
def test_resolve_spec_matches_jax(shape, names, mesh, rules):
    if mesh == "1x1":
        jm = jax.sharding.AbstractMesh((1, 1), ("data", "model"))
        tm = shd.AbstractMesh({"data": 1, "model": 1})
    else:
        jm, tm = _meshes(mesh)
    if rules is None or rules == "multi_pod":
        jr = jshd.default_rules(multi_pod=rules == "multi_pod")
        tr = shd.default_rules(multi_pod=rules == "multi_pod")
    else:
        jr = tr = rules
    assert shd.resolve_spec(shape, names, tm, tr) == tuple(
        jshd.resolve_spec(shape, names, jm, jr))


def test_resolve_without_mesh_and_constrain_identity():
    x = np.arange(12).reshape(3, 4)
    assert shd.resolve_spec((3, 4), ("batch", "mlp")) == ()
    assert shd.constrain(x, "batch", "mlp") is x
    assert shd.named_sharding((3, 4), ("batch",)) is None
    assert shd.constrain_index_plane(x) is x
    with shd.use_mesh(shd.AbstractMesh({"data": 1, "model": 2}),
                      shd.default_rules()):
        assert shd.resolve_spec((3, 4), ("batch", "mlp")) == (
            "data", "model")
        assert shd.active_rules()["mlp"] == ("model",)
    assert shd.active_mesh() is None and shd.active_rules() == {}


# ---------------------------------------------------------------------------
# (b) the parameter and cache spec trees of every arch at full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mesh", list(itertools.product(
    registry.ARCHS, MESHES)))
def test_param_and_cache_specs_match_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    multi = "pod" in tm.shape
    cfg, tcfg = registry.get(arch), treg.get(arch)
    jp, jaxes = jzoo.build_params(cfg, abstract=True)
    tp, taxes = zoo.param_axes(tcfg)
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == \
        {k: (tuple(v.shape) if not isinstance(v, dict) else
             {kk: tuple(vv.shape) for kk, vv in v.items()})
         for k, v in tp.items()}
    assert taxes == jaxes
    want = _spec_tree(jly.axes_to_specs(
        jp, jaxes, jm, jshd.default_rules(multi_pod=multi)))
    assert ly.axes_to_specs(tp, taxes, tm,
                            shd.default_rules(multi_pod=multi)) == want
    jc = jzoo.init_cache(cfg, 16, 4096, abstract=True)
    tc = zoo.init_cache(tcfg, 16, 4096, device="meta")
    cax = zoo.cache_axes(tcfg)
    assert cax == jzoo.cache_axes(cfg)
    for k in cax:
        assert tuple(tc[k].shape) == tuple(jc[k].shape), k
        assert shd.resolve_spec(tc[k].shape, cax[k], tm,
                                shd.default_rules(multi_pod=multi)) == \
            tuple(jshd.resolve_spec(jc[k].shape, cax[k], jm,
                                    jshd.default_rules(multi_pod=multi)))


def test_minitron_on_four_ranks_is_whole_heads():
    """minitron-8b on 1 x 4: ``wq`` 8 heads and ``wk``/``wv`` 2 kv
    heads a rank (the GQA group of its q heads), a 2-kv-head cache
    block, a quarter of the vocab, and about 4.94 GB a rank in bf16."""
    cfg = treg.get("minitron-8b")
    tm = shd.AbstractMesh({"data": 1, "model": 4})
    p, axes = zoo.param_axes(cfg)
    specs = ly.axes_to_specs(p, axes, tm, shd.default_rules())
    assert specs["wq"] == specs["wk"] == (None, "data", "model")
    assert specs["wo"] == (None, "model", "data")
    assert specs["embed"] == ("model",) and specs["unembed"] == (
        None, "model")
    per_rank = sum(v.numel() // (4 if specs[k] else 1)
                   for k, v in p.items())
    assert abs(2 * per_rank / 1e9 - 4.94) < 0.01
    spec = shd.resolve_spec((32, 4, 128, 8, 128), zoo.cache_axes(cfg)["k"],
                            tm, shd.default_rules())
    assert spec == (None, "data", None, "model")


# ---------------------------------------------------------------------------
# (c), (d), (g): the sharded model and engine on 2 and 4 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    out = {}
    for arch in mc.MODEL_ARCHS:
        cfg = registry.get_smoke(arch)
        params, _ = jzoo.build_params(cfg, jax.random.PRNGKey(0))
        out[arch] = (cfg, params, jax.tree.map(np.asarray, params))
    return out


def _reference(smoke):
    """The JAX package's meshless forward, decode steps and greedy ids,
    and its meshless engine on each case."""
    out = {}
    for arch in mc.MODEL_ARCHS:
        cfg, params, _ = smoke[arch]
        toks = jnp.asarray(mc.model_inputs(cfg.vocab))
        fwd = np.asarray(jzoo.forward(params, cfg, toks))
        cache = jzoo.init_cache(cfg, 2, 16)
        steps = []
        for t in range(mc.DECODE_STEPS):
            logits, cache = jzoo.decode_step(params, cfg, toks[:, t:t + 1],
                                             cache, jnp.int32(t))
            steps.append(np.asarray(logits))
        out[arch] = (fwd, steps)
    from repro.core import workload as wl
    cfg, params, _ = smoke[mc.ENGINE_ARCH]
    for case, (arr_kw, kw) in mc.ENGINE_CASES.items():
        eng = Engine(cfg, params, **dict(mc.ENGINE_ARGS, **kw))
        mc.submit_arrivals(eng, wl.poisson_zipf_arrivals(**arr_kw), Request)
        out[case] = mc.engine_summary(eng, eng.run())
    return out


@pytest.fixture(scope="module")
def runs(smoke):
    """The port's worlds of 2 and 4 ranks (launched together) and, while
    they run, the JAX reference: ``(port {S: per-rank results},
    reference)``."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch import spmd
    params_np = {a: smoke[a][2] for a in mc.MODEL_ARCHS}
    with ThreadPoolExecutor(2) as ex:
        worlds = {S: ex.submit(spmd.spawn, mc.model_mesh_rank, S, params_np,
                               device="cpu", threads=1, timeout=600)
                  for S in (2, 4)}
        ref = _reference(smoke)
        return {S: f.result() for S, f in worlds.items()}, ref


@pytest.fixture(scope="module")
def port(runs):
    return runs[0]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1]


@pytest.mark.parametrize("arch,S", list(itertools.product(mc.MODEL_ARCHS,
                                                          (2, 4))))
def test_sharded_forward_and_decode_match_jax(port, reference, arch, S):
    """Every rank's forward and decode-step logits (gathered whole) are
    allclose to the JAX package's meshless ones, and the greedy ids
    equal: on 2 ranks whole heads and a split cache, on 4 split heads
    (a kv head over two ranks) and a replicated cache."""
    fwd, steps = reference[arch]
    greedy = np.argmax(steps[-1][:, -1], -1).tolist()
    for r, out in enumerate(port[S]):
        np.testing.assert_allclose(out["fwd"][arch], fwd, rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {r}")
        for t, (got, want) in enumerate(zip(out["dec"][arch], steps)):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} step {t}")
        assert out["greedy"][arch] == greedy, r
        assert out["cache_kv_heads"][arch] == (1 if S == 2 else 2)
        assert out["specs"][arch]["wk"] == (None, "data", "model")


@pytest.mark.parametrize("case,kind,S", list(itertools.product(
    mc.ENGINE_CASES, ("global", "laid_out"), (2, 4))))
def test_engine_on_mesh_matches_jax(port, reference, case, kind, S):
    """``Engine(mesh=...)`` with the global and with the laid-out tree,
    on every rank, equals the JAX package's meshless engine on the same
    arrivals: generated ids, latencies, stalls, preemptions, retries,
    tokens out, the pool's chains and free list, the vocab counters."""
    want = reference[case]
    for r, out in enumerate(port[S]):
        got = out["engine"][case, kind]
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == want[k], (r, k)
    if case == "burst_tight_pool":
        assert want["stalls"] + want["preemptions"] > 0


# ---------------------------------------------------------------------------
# (f) the elastic re-lay
# ---------------------------------------------------------------------------

def _block(a, spec, coords, shape):
    """The slice of ``a`` a rank at ``coords`` holds under ``spec`` (an
    independent reading of the layout: axes row-major, the last one
    fastest)."""
    idx = []
    for d, n in enumerate(a.shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else (e,) if isinstance(e, str) else e
        k, i = 1, 0
        for ax in axes:
            k *= shape[ax]
            i = i * shape[ax] + coords[ax]
        idx.append(slice(i * n // k, (i + 1) * n // k))
    return a[tuple(idx)]


def test_reshard_across_a_change_of_mesh_shape(smoke):
    """A flat host tree laid out on a 2 x 2 (data, model) mesh with fsdp
    over data, then on the 1 x 2 mesh of the survivors: every block bit
    for bit the slice of the global array, and ``gather_param`` leaves
    the model-axis block."""
    from repro_torch.launch import spmd
    cfg = treg.get_smoke("minitron-8b")
    flat = {k: v for k, v in smoke["minitron-8b"][2].items()}
    _, axes = zoo.param_axes(cfg)
    s22 = {"data": 2, "model": 2}
    s12 = {"data": 1, "model": 2}
    specs22 = ly.axes_to_specs(flat, axes, shd.AbstractMesh(s22),
                               shd.default_rules())
    specs12 = ly.axes_to_specs(flat, axes, shd.AbstractMesh(s12),
                               shd.default_rules())
    assert specs22["wq"] == (None, "data", "model")
    out = spmd.spawn(mc.relay_rank, 4, flat, specs22, specs12,
                     device="cpu", threads=1, timeout=300)
    for r, o in enumerate(out):
        assert o["coords22"] == {"data": r // 2, "model": r % 2}
        for k, a in flat.items():
            want = _block(a, specs22[k], o["coords22"], s22)
            assert o["b22"][k].dtype == a.dtype
            np.testing.assert_array_equal(o["b22"][k], want, err_msg=k)
        for k, g in o["gathered"].items():
            np.testing.assert_array_equal(
                g, _block(flat[k], specs12[k], {"data": 0,
                                                "model": r % 2}, s12))
        if r >= 2:
            assert o["coords12"] is None and "b12" not in o
            continue
        assert o["coords12"] == {"data": 0, "model": r}
        for k, a in flat.items():
            np.testing.assert_array_equal(
                o["b12"][k], _block(a, specs12[k], o["coords12"], s12))


@pytest.mark.parametrize("args", [(256, 4, 2, 1), (256, 4, 4, 2),
                                  (256, 4, 3, 2), (256, 2, 4, 8),
                                  (8, 16, 1, 1)])
def test_scale_microbatch_matches_jax(args):
    assert telastic.scale_microbatch(*args) == \
        jelastic.scale_microbatch(*args)

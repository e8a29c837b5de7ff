"""The other model families on a mesh (moe, ssm, hybrid, encdec, vlm;
fsdp and the batch over a ``data`` axis) against the JAX package's
meshless functions.

The port's laid-out models run on gloo worlds of 2 and 4 CPU ranks
(``launch.spmd.spawn``, one launch a world for every case,
``mesh_cases.family_mesh_rank``): the smoke variants of the six family
archs on ``1 x 2`` and ``1 x 4``, the phi smoke with 6 experts (which 4
ranks do not divide, so ``mlp`` takes the axis) on ``1 x 4``, and the
dense and moe smokes on the ``2 x 2`` (data, model) mesh of the 4
ranks, each rank passing its row of the batch.  Every rank's results
are gathered whole and held against the JAX package's meshless
``forward``/``decode_step`` (from ``build_params(cfg, PRNGKey(0))``,
converted by ``convert.params_from_numpy``) at rtol 1e-4, atol 1e-5:
the forward stage by stage (each stage from the JAX state, read through
the JAX head, since the smoke models amplify float32 rounding; ROADMAP
§C), the tapped logits, the untapped pass's greedy ids, and three
decode steps' logits, each from the JAX cache before it (a miss held by
a float64 witness, ``card_checks.Agreement``'s rule) and their greedy
ids from the rank's own cache.  The MoE blocks run alone on the same inputs on
both sides, so the routing, the kept mask and the drops are held
equal.  ``Engine(mesh=...)`` with the laid-out moe smoke tree equals
the JAX meshless engine field for field.  The sequence layouts are
held in ``tests/test_torch_seq_layouts.py``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_cases as mc
from repro.configs import registry
from repro.core import workload as wl
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro.serve.engine import Engine, Request
from repro_torch.configs import registry as treg
from repro_torch.models import layers as ly
from repro_torch.models import model_zoo as zoo
from repro_torch.parallel import sharding as shd

RTOL, ATOL = 1e-4, 1e-5
WORLDS = (2, 4, "2x2")
MODEL_CASES = [(w, name) for w in WORLDS for name in mc.FAMILY_MODELS[w]]
F32 = jnp.float32


def _jax_stages(params, cfg, toks, fr):
    """The reference's forward, stage by stage (eager): stage name ->
    hidden state after it, and the logits."""
    out = {}
    x = jzoo.embed_tokens(params, cfg, jnp.asarray(toks), F32)
    mm, pl, enc = "causal", 0, None
    if cfg.family == "vlm":
        x = jnp.concatenate([jnp.asarray(fr), x], axis=1)
        mm, pl = "prefix", cfg.img_tokens
    out["embed"] = x
    if cfg.family == "encdec":
        e = jnp.asarray(fr) + params["enc_pos"][None]
        for i in range(cfg.n_enc_layers):
            lp = {k[len("enc_"):]: params[k][i] for k in params
                  if k.startswith("enc_") and k != "enc_pos"}
            a, _ = jzoo._attn_block(e, lp, cfg, "full", 0, F32)
            e = e + a
            e = e + jzoo._mlp_block(e, lp, cfg, F32)
            out[f"enc{i}"] = e
        enc = e
    keys = jzoo._layer_keys(params, cfg)
    for i in range(cfg.n_layers):
        x = jzoo._decoder_block(x, {k: params[k][i] for k in keys}, cfg,
                                F32, mm, pl, enc)
        out[f"layer{i}"] = x
        if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
            sh = params["shared_attn"]
            a, _ = jzoo._attn_block(x, sh, cfg, mm, pl, F32)
            x = x + a
            x = x + jzoo._mlp_block(x, sh, cfg, F32)
            out[f"shared{i}"] = x
    if cfg.family == "vlm":
        x = x[:, cfg.img_tokens:]
    return out, jzoo.logits_out(params, cfg, x, F32)


def _jax_routing(cfg, p, x):
    """The reference block's routing, exactly: top-k experts ``[b, s,
    k]`` and each group's kept mask over its expert-sorted entries."""
    gates = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, p["router"]), -1)
    _, top_e = jax.lax.top_k(gates, cfg.top_k)
    cap = max(int(x.shape[1] * cfg.top_k / cfg.n_experts
                  * cfg.capacity_factor) + 1, cfg.top_k)
    keeps = []
    for eg in np.asarray(top_e):
        se = jnp.sort(jnp.asarray(eg.reshape(-1)))
        start = jnp.searchsorted(se, jnp.arange(cfg.n_experts), side="left")
        keeps.append(np.asarray(jnp.arange(se.shape[0]) - start[se] < cap))
    return np.asarray(top_e), np.stack(keeps)


def _names():
    return sorted({n for w in WORLDS for n in mc.FAMILY_MODELS[w]})


def _jax_decode(params, cfg, toks):
    """The reference's decode steps from an empty cache: each step's
    logits, and the cache before each step."""
    cache = jzoo.init_cache(cfg, toks.shape[0], 16)
    steps, caches = [], []
    for t in range(mc.FAMILY_STEPS):
        caches.append({k: np.asarray(v) for k, v in cache.items()})
        logits, cache = jzoo.decode_step(
            params, cfg, jnp.asarray(toks[:, t:t + 1]), cache, jnp.int32(t))
        steps.append(np.asarray(logits))
    return steps, caches


@pytest.fixture(scope="module")
def smoke():
    """name -> (cfg, JAX params, numpy params, stages, logits, decode
    steps' logits, caches before them)."""
    out = {}
    for name in _names():
        cfg = mc.family_cfg(registry, name)
        params, _ = jzoo.build_params(cfg, jax.random.PRNGKey(0))
        toks, fr = mc.family_inputs(cfg)
        stages, logits = _jax_stages(params, cfg, toks, fr)
        out[name] = (cfg, params, jax.tree.map(np.asarray, params),
                     {k: np.asarray(v) for k, v in stages.items()},
                     np.asarray(logits)) + _jax_decode(params, cfg, toks)
    return out


def _reference(smoke):
    """The JAX package's untapped forward, the MoE blocks, and its
    meshless engine on the moe smoke."""
    out = {"fwd": {}, "moe": {}, "engine": {}}
    for name, (cfg, params) in ((n, v[:2]) for n, v in smoke.items()):
        toks, fr = mc.family_inputs(cfg)
        out["fwd"][name] = np.asarray(jzoo.forward(
            params, cfg, jnp.asarray(toks),
            frontend=None if fr is None else jnp.asarray(fr)))
    for case in mc.MOE_BLOCK_CASES:
        name, p, x = mc.moe_block_case(registry, case)
        cfg = mc.family_cfg(registry, name)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        y = np.asarray(jmoe.moe_block(jnp.asarray(x), jp, cfg, F32))
        out["moe"][case] = (y,) + _jax_routing(cfg, jp, jnp.asarray(x))
    cfg, params = smoke[mc.MOE_ARCH][:2]
    for case, (arr_kw, kw) in mc.ENGINE_CASES.items():
        eng = Engine(cfg, params, **dict(mc.ENGINE_ARGS, **kw))
        mc.submit_arrivals(eng, wl.poisson_zipf_arrivals(**arr_kw), Request)
        out["engine"][case] = mc.engine_summary(eng, eng.run())
    return out


@pytest.fixture(scope="module")
def runs(smoke):
    """The port's worlds of 2 and 4 ranks (launched together) and, while
    they run, the JAX reference."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch import spmd
    job = {"params": {n: v[2] for n, v in smoke.items()},
           "stages": {n: v[3] for n, v in smoke.items()},
           "caches": {n: v[6] for n, v in smoke.items()}}
    with ThreadPoolExecutor(2) as ex:
        worlds = {S: ex.submit(spmd.spawn, mc.family_mesh_rank, S, job,
                               device="cpu", threads=1, timeout=900)
                  for S in (2, 4)}
        ref = _reference(smoke)
        return {S: f.result() for S, f in worlds.items()}, ref


def _ranks(runs, world):
    return runs[0][4 if world == "2x2" else world]


def _close(got, want, msg):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=msg)


def _step64(name, params_np, caches, t):
    """The float64 witness of decode step ``t``: the port's meshless
    step in float64 (``card_checks.float64_mode``) from the JAX cache
    before it."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    from card_checks import as_float64, float64_mode

    from repro_torch.core import convert
    cfg = mc.family_cfg(treg, name)
    p64 = as_float64(convert.params_from_numpy(params_np, device="cpu"))
    c64 = as_float64({k: torch.as_tensor(v) for k, v in caches[t].items()})
    toks, _ = mc.family_inputs(cfg)
    with torch.no_grad(), float64_mode(torch):
        logits, _ = zoo.decode_step(
            p64, cfg, torch.as_tensor(toks[:, t:t + 1].astype(np.int64)),
            c64, t)
    return logits.numpy()


def _close_or_witnessed(got, want, witness, msg):
    """``got`` allclose to ``want`` (the JAX float32); where that misses,
    ``got`` lies at most twice as far from the float64 ``witness()`` as
    ``want`` does (``card_checks.Agreement``'s rule: two float32 results
    of one ill-conditioned computation err by comparable amounts)."""
    if np.allclose(got, want, rtol=RTOL, atol=ATOL):
        return
    w = witness()
    e_got = float(np.abs(got.astype(np.float64) - w).max())
    e_want = float(np.abs(want.astype(np.float64) - w).max())
    assert e_got <= 2 * e_want, (msg, e_got, e_want)


@pytest.mark.parametrize("world,name", MODEL_CASES)
def test_forward_stages_match_jax(smoke, runs, world, name):
    """Each stage of the laid-out forward, from the JAX state before it,
    read through the JAX head, and the tapped logits, on every rank;
    the untapped pass's greedy ids equal the JAX forward's."""
    cfg, params, _, stages, logits = smoke[name][:5]
    for r, out in enumerate(_ranks(runs, world)):
        res = out["models"][world, name]
        assert list(res["stages"]) == list(stages), r
        for k, x in res["stages"].items():
            _close(np.asarray(jzoo.logits_out(params, cfg, jnp.asarray(x),
                                              F32)),
                   np.asarray(jzoo.logits_out(params, cfg,
                                              jnp.asarray(stages[k]), F32)),
                   f"rank {r} stage {k}")
        _close(res["tapped"], logits, f"rank {r} logits")
        np.testing.assert_array_equal(
            res["fwd"].argmax(-1), runs[1]["fwd"][name].argmax(-1))


@pytest.mark.parametrize("world,name", MODEL_CASES)
def test_decode_steps_match_jax(smoke, runs, world, name):
    """Three decode steps, each from the JAX cache before it laid out on
    the mesh: every rank's logits (gathered whole) allclose to the JAX
    meshless steps', or, where a near-zero logit misses, at most twice
    as far from the float64 step as JAX's float32 is; the same steps from the rank's own laid-out cache
    give the JAX steps' greedy ids; the cache's blocks split as
    ``cache_axes`` resolves."""
    want = smoke[name][5]
    mesh_shape = ({"data": 2, "model": 2} if world == "2x2"
                  else {"data": 1, "model": world})
    am = shd.AbstractMesh(mesh_shape)
    tc = zoo.init_cache(mc.family_cfg(treg, name), mc.FAMILY_SHAPE[0], 16,
                        device="meta")
    cax = zoo.cache_axes(mc.family_cfg(treg, name))
    for r, out in enumerate(_ranks(runs, world)):
        res = out["models"][world, name]
        for t, (got, w) in enumerate(zip(res["dec"], want)):
            _close_or_witnessed(
                got, w, lambda: _step64(name, smoke[name][2], smoke[name][6],
                                        t), f"rank {r} step {t}")
            np.testing.assert_array_equal(res["free"][t], w.argmax(-1))
        for k, shape in res["cache_shapes"].items():
            spec = shd.resolve_spec(tc[k].shape, cax[k], am,
                                    shd.default_rules())
            assert shape == shd.local_shape(tc[k].shape, spec, am), (k, r)


@pytest.mark.parametrize("world,case", list(itertools.product(
    WORLDS, mc.MOE_BLOCK_CASES)))
def test_moe_block_on_mesh_matches_jax(runs, world, case):
    """The MoE block laid out on the mesh, alone on the JAX inputs:
    every rank's routing (top-k experts) and kept mask equal the
    reference's, so its drops do, and its output (its rows) is allclose
    to the reference block's.  The experts split over ``model`` where
    their count divides, else ``mlp`` takes it."""
    y, top_e, keep = runs[1]["moe"][case]
    for r, out in enumerate(_ranks(runs, world)):
        res = out["moe"][world, case]
        rows = res["rows"]
        np.testing.assert_array_equal(res["top_e"], top_e[rows])
        np.testing.assert_array_equal(res["keep"], keep[rows])
        _close(res["y"], y[rows], f"rank {r}")
        split = res["w_gate"]
        if case == "experts6" and world == 4:
            assert split == (None, "data", "model")
        elif world == "2x2":
            assert split == ("model", "data")
        else:
            assert split[0] == "model"
    if case == "drops":      # expert 0 first for most tokens, over capacity
        assert (top_e[..., 0] == 0).mean() > 0.8 and (~keep).sum() > 0


@pytest.mark.parametrize("case,S", list(itertools.product(
    mc.ENGINE_CASES, (2, 4))))
def test_moe_engine_on_mesh_matches_jax(runs, case, S):
    """``Engine(mesh=...)`` with the laid-out moe smoke tree, on every
    rank, equals the JAX meshless engine on the same arrivals: ids,
    latencies, stalls, preemptions, retries, tokens out, the pool's
    chains and free list, the vocab counters."""
    want = runs[1]["engine"][case]
    for r, out in enumerate(runs[0][S]):
        got = out["engine"][case]
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == want[k], (r, k)


def test_two_by_two_mesh_coordinates(runs):
    """The 4 ranks' 2 x 2 mesh: data the slow axis, model the fast."""
    for r, out in enumerate(runs[0][4]):
        assert out["coords"]["2x2"] == {"data": r // 2, "model": r % 2}


def test_engine_refuses_a_batch_split_over_data(runs):
    """``Engine(mesh=...)`` serves every row of a wave on every rank, so
    a tree laid out on the 2 x 2 mesh, whose rules split the batch over
    ``data``, is refused on every rank."""
    for out in runs[0][4]:
        assert out["engine_2x2"] is not None
        assert "split the batch over ('data',)" in out["engine_2x2"]


# ---------------------------------------------------------------------------
# the full-size layouts phase 14 of chip_smoke.py runs
# ---------------------------------------------------------------------------

def _bytes_a_rank(arch, shape, n_layers=None):
    import dataclasses
    cfg = dataclasses.replace(treg.get(arch), param_dtype="bfloat16")
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    p, axes = zoo.param_axes(cfg)
    am = shd.AbstractMesh(shape)
    specs = ly.axes_to_specs(p, axes, am, shd.default_rules())

    def walk(t, s):
        if isinstance(t, dict):
            return sum(walk(t[k], s[k]) for k in t)
        return 2 * int(np.prod(shd.local_shape(t.shape, s, am)))
    return walk(p, specs), specs


@pytest.mark.parametrize("arch,layers,shape,want", [
    ("phi3.5-moe-42b-a6.6b", 8, {"data": 1, "model": 4}, 5268185088),
    ("phi3.5-moe-42b-a6.6b", 8, {"data": 2, "model": 2}, 5334245376),
    ("zamba2-7b", None, {"data": 1, "model": 4}, 3323976232),
    ("whisper-large-v3", None, {"data": 1, "model": 4}, 981230080),
    ("paligemma-3b", None, {"data": 1, "model": 4}, 1254510592)])
def test_full_width_bytes_a_rank(arch, layers, shape, want):
    """The bf16 bytes a rank holds of each phase-14 model: phi's experts
    4 a rank on 1 x 4 (and 8 a rank, fsdp over data, on 2 x 2),
    zamba2's 28 Mamba2 heads and 8 kv heads a rank, and the specs the
    head split reads."""
    got, specs = _bytes_a_rank(arch, shape, layers)
    assert got == want
    if arch.startswith("phi") and shape["data"] == 1:
        assert specs["w_gate"] == (None, "model", "data")
    if arch == "zamba2-7b":
        assert specs["dt_bias"] == (None, "model")
        assert specs["in_proj"] == (None, "data", "model")
        assert specs["out_proj"] == (None, "model", "data")
        assert specs["shared_attn"]["wk"] == ("data", "model")

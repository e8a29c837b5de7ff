"""PyTorch port, the model zoo: ``repro_torch.models`` and
``serve/serve_step.py`` against the JAX package on the CPU, float32
smoke variants, parameters from ``zoo.build_params(cfg, PRNGKey(0))``
converted array by array (``convert.params_from_numpy``).  Float
outputs are held with ``allclose(rtol=1e-4, atol=1e-5)``, integer ones
(int8 KV values, MoE top-k and dispatch, greedy tokens) exactly.

Per module: ``rms_norm``, ``rope``, ``swiglu``, the attention family
(full under each mask, blockwise at a small chunk, the dispatch rule,
grouped decode, ``quantize_kv``, int8 decode), ``moe_block`` (tied
gates, a capacity overflow that drops tokens, arctic's residual),
``ssd_chunked``, ``mamba2_decode`` and the clamped cache write.  Per
architecture: ``forward``, ``init_cache`` and ``decode_step``.

The smoke models are ill-conditioned in float32: the reference's
initializer takes a stacked weight's leading (layer) axis as its fan-in,
so the stacked weights are drawn at 1/sqrt(n_layers) and the hidden
states grow far above 1.  Ulp-level differences between XLA's and
torch's exp, rsqrt and sin then grow across a whole forward pass to the
size of the tolerance on the logits of some batches.  So ``forward`` is compared stage by stage: each stage
(embedding, encoder layer, decoder layer, shared block) starts both
packages from the JAX state, and its output is read through the
model's own head (final norm and unembedding) on both sides before the
comparison.  Decode steps are compared end to end.  State tensors (KV
caches, SSM states) hold entries that are sums of large terms
cancelling to near zero, so they are held to the same tolerance
norm-wise, against their largest entry.  Beside these, the whole
untapped pass and the caches are held elementwise for the archs that
pass so on these inputs; ``PYTHONPATH=src python
tests/test_torch_models.py`` prints every arch's readings (the excess
``max |got - want| / (atol + rtol |want|)`` at each stage and step)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry
from repro.models import attention as jat
from repro.models import layers as jly
from repro.models import model_zoo as zoo
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.serve import serve_step as ss
from repro_torch.configs import registry as treg
from repro_torch.core import convert
from repro_torch.models import attention as tat
from repro_torch.models import layers as tly
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.serve import serve_step as tss

ARCHS = list(registry.ARCHS)
TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, msg=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, err_msg=msg, **TOL)


def _close_state(got, want, msg=""):
    """A state tensor (KV cache, SSM state, the SSD scan's output):
    entries are sums of large terms that cancel to near zero, so
    the same tolerance holds norm-wise, against its largest entry:
    ``max|got - want| <= atol + rtol * max|want|``."""
    got = got.detach().cpu().numpy().astype(np.float64)
    want = np.asarray(want).astype(np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    lim = TOL["atol"] + TOL["rtol"] * float(np.abs(want).max(initial=0.0))
    assert err <= lim, (msg, err, lim)


_PARAMS = {}


def _models(arch):
    """(JAX cfg, JAX params, port cfg, port params on the CPU)."""
    if arch not in _PARAMS:
        cfg = registry.get_smoke(arch)
        params, _ = zoo.build_params(cfg, jax.random.PRNGKey(0))
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                       device="cpu")
        _PARAMS[arch] = (cfg, params, treg.get_smoke(arch), tp)
    return _PARAMS[arch]


def _frontend(cfg, B):
    """The stub modality input, at the embedding's scale (0.02)."""
    n = {"encdec": cfg.enc_positions, "vlm": cfg.img_tokens}.get(
        cfg.family)
    if n is None:
        return None
    rng = np.random.default_rng(5)
    return (0.02 * rng.standard_normal((B, n, cfg.d_model))).astype(
        np.float32)


# ---------------------------------------------------------------------------
# configs and converted parameters
# ---------------------------------------------------------------------------

def test_registry_matches_jax():
    assert list(treg.ARCHS) == list(registry.ARCHS)
    for arch in ARCHS:
        for get in ("get", "get_smoke"):
            a = dataclasses.asdict(getattr(registry, get)(arch))
            b = dataclasses.asdict(getattr(treg, get)(arch))
            assert a == b, (arch, get)
        assert treg.sub_quadratic(treg.get(arch)) == \
            registry.sub_quadratic(registry.get(arch))


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-large-v3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip(arch, dtype):
    """JAX parameters -> tensors -> numpy, bit for bit: nested trees
    (zamba2's ``shared_attn``) and bfloat16 as ``ml_dtypes`` arrays."""
    cfg = dataclasses.replace(registry.get_smoke(arch), param_dtype=dtype)
    params, _ = zoo.build_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    tp = convert.params_from_numpy(tree, device="cpu")
    back = convert.params_to_numpy(tp)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert tp["embed"].dtype == want
    if arch == "zamba2-7b":
        assert set(tp["shared_attn"]) == set(tree["shared_attn"])


@pytest.mark.parametrize("arch", ["minitron-8b", "zamba2-7b",
                                  "arctic-480b", "whisper-large-v3"])
def test_build_params_tree_matches_jax(arch):
    """The port's own builder: the reference's names, nesting, shapes
    and dtype; ones, zeros and the negative SSM decay where the
    reference puts them."""
    cfg, params, tcfg, _ = _models(arch)
    tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16")
    tp = tzoo.build_params(tcfg, seed=3, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, params))[0]
    got = jax.tree_util.tree_flatten_with_path(
        {k: (dict(v) if isinstance(v, dict) else v) for k, v in tp.items()},
        is_leaf=torch.is_tensor)[0]
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        assert tuple(b.shape) == a.shape and b.dtype == torch.bfloat16, path
    assert bool((tp["ln_f"] == 1).all())
    if "A" in tp:
        assert bool((tp["A"] < 0).all()) and bool((tp["D"] == 1).all())
    again = tzoo.build_params(tcfg, seed=3, device="cpu")
    assert torch.equal(again["embed"], tp["embed"])


# ---------------------------------------------------------------------------
# per module
# ---------------------------------------------------------------------------

def test_rms_norm_rope_swiglu():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    _close(tly.rms_norm(_t(x), _t(g), 1e-6),
           jly.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6))
    # bf16 in and out, statistics in float32: the same bits
    xb = jnp.asarray(x, jnp.bfloat16)
    got = tly.rms_norm(convert.table_from_numpy(np.asarray(xb),
                                                device="cpu"),
                       _t(g), 1e-6)
    want = np.asarray(jly.rms_norm(xb, jnp.asarray(g), 1e-6))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    q = rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
    pos = np.arange(3, 11)[None]
    for theta in (1e4, 1e6):
        _close(tly.rope(_t(q), _t(pos), theta),
               jly.rope(jnp.asarray(q), jnp.asarray(pos), theta))
    w = [rng.standard_normal(s).astype(np.float32) * 0.1
         for s in ((64, 96), (64, 96), (96, 64))]
    _close(tly.swiglu(_t(x), *map(_t, w), torch.float32),
           jly.swiglu(jnp.asarray(x), *map(jnp.asarray, w), jnp.float32))


def _qkv(b=2, sq=12, sk=12, h=4, kv=2, d=16, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]


@pytest.mark.parametrize("mask", ["causal", "prefix", "full"])
def test_full_attention_masks(mask):
    q, k, v = _qkv()
    _close(tat.full_attention(*map(_t, (q, k, v)), mask, prefix_len=5),
           jat.full_attention(*map(jnp.asarray, (q, k, v)), mask,
                              prefix_len=5))


@pytest.mark.parametrize("mask", ["causal", "prefix"])
def test_blockwise_attention(mask):
    q, k, v = _qkv(sq=16, sk=16)
    got = tat.blockwise_attention(*map(_t, (q, k, v)), mask, prefix_len=6,
                                  kv_chunk=4)
    _close(got, jat.blockwise_attention(*map(jnp.asarray, (q, k, v)), mask,
                                        prefix_len=6, kv_chunk=4))
    _close(got, tat.full_attention(*map(_t, (q, k, v)), mask,
                                   prefix_len=6))


def test_attention_dispatch_rule():
    """The constants and the rule pick the summation order: blockwise
    only for square self-attention past 2048 in whole 1024-chunks."""
    assert (tat.BLOCKWISE_THRESHOLD, tat.KV_CHUNK) == \
        (jat.BLOCKWISE_THRESHOLD, jat.KV_CHUNK) == (2048, 1024)
    q, k, v = _qkv(b=1, sq=3072, sk=3072, h=2, kv=1, d=8, seed=2)
    got = tat.attention(*map(_t, (q, k, v)))
    assert torch.equal(got, tat.blockwise_attention(*map(_t, (q, k, v))))
    _close(got, jat.attention(*map(jnp.asarray, (q, k, v))))
    q2, k2, v2 = _qkv(sq=9, sk=9)
    assert torch.equal(tat.attention(*map(_t, (q2, k2, v2))),
                       tat.full_attention(*map(_t, (q2, k2, v2))))


@pytest.mark.parametrize("cache_len", [1, 7, 12])
def test_decode_attention(cache_len):
    q, k, v = _qkv(sq=1, sk=12)
    _close(tat.decode_attention(*map(_t, (q, k, v)), cache_len),
           jat.decode_attention(*map(jnp.asarray, (q, k, v)), cache_len))


def test_quantize_kv_and_q8_decode():
    _, k, v = _qkv(sk=12)
    k[0, 3] = 0.0                                 # an all-zero token
    kq, ks = tat.quantize_kv(_t(k))
    jkq, jks = jat.quantize_kv(jnp.asarray(k))
    assert kq.dtype == torch.int8 and ks.dtype == torch.float32
    np.testing.assert_array_equal(kq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    vq, vs = jat.quantize_kv(jnp.asarray(v))
    q = _qkv(sq=1, sk=12)[0]
    args = (np.asarray(jkq), np.asarray(vq), np.asarray(jks),
            np.asarray(vs))
    for n in (5, 12):
        _close(tat.decode_attention_q8(_t(q), *map(_t, args), n),
               jat.decode_attention_q8(jnp.asarray(q),
                                       *map(jnp.asarray, args), n))


def _moe_case(arch, router_scale=1.0, capacity_factor=None, seed=0):
    """One MoE layer's weights at 1/sqrt(fan_in) and unit inputs."""
    cfg = registry.get_smoke(arch)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    d, ff, e, rf = cfg.d_model, cfg.d_ff, cfg.n_experts, \
        cfg.dense_residual_ff
    shapes = {"router": (d, e), "w_gate": (e, d, ff), "w_up": (e, d, ff),
              "w_down": (e, ff, d)}
    if rf:
        shapes.update(res_gate=(d, rf), res_up=(d, rf), res_down=(rf, d))
    rng = np.random.default_rng(seed)
    p = {n: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
         for n, s in shapes.items()}
    p["router"] = p["router"] * np.float32(router_scale)
    x = rng.standard_normal((2, 12, d)).astype(np.float32)
    return cfg, p, x


@pytest.mark.parametrize("case", ["tied_gates", "overflow", "residual"])
def test_moe_block(case):
    arch = "arctic-480b" if case == "residual" else "phi3.5-moe-42b-a6.6b"
    cfg, p, x = _moe_case(
        arch, router_scale=0.0 if case == "tied_gates" else 1.0,
        capacity_factor=0.5 if case == "overflow" else None)
    # the routing decisions, exactly: top-k (lower expert first on ties)
    # and the sort-based dispatch, dropping past capacity
    gates = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, p["router"]), -1)
    jg, je = jax.lax.top_k(gates, cfg.top_k)
    tg, te = tmoe.top_k(_t(np.asarray(gates)), cfg.top_k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    cap = tmoe.capacity(x.shape[1], cfg)
    assert cap == max(int(12 * cfg.top_k / cfg.n_experts
                          * cfg.capacity_factor) + 1, cfg.top_k)
    dropped = 0
    for eg in np.asarray(je):
        flat_e = jnp.asarray(eg.reshape(-1))
        order = jnp.argsort(flat_e)
        se = flat_e[order]
        start = jnp.searchsorted(se, jnp.arange(cfg.n_experts), side="left")
        rank = jnp.arange(flat_e.shape[0]) - start[se]
        keep = rank < cap
        slot = jnp.where(keep, se * cap + rank, cfg.n_experts * cap)
        t_order, t_stok, t_slot, t_keep = tmoe.dispatch(
            _t(eg).long(), cfg.n_experts, cap)
        np.testing.assert_array_equal(t_order.numpy(), np.asarray(order))
        np.testing.assert_array_equal(
            t_stok.numpy(), np.repeat(np.arange(12), cfg.top_k)[order])
        np.testing.assert_array_equal(t_slot.numpy(), np.asarray(slot))
        np.testing.assert_array_equal(t_keep.numpy(), np.asarray(keep))
        dropped += int((~np.asarray(keep)).sum())
    if case == "overflow":
        assert dropped > 0, "the capacity overflow dropped nothing"
    if case == "tied_gates":
        assert (np.asarray(je) == np.arange(cfg.top_k)).all()
    got = tmoe.moe_block(_t(x), {k: _t(v) for k, v in p.items()}, cfg,
                         torch.float32)
    _close(got, jmoe.moe_block(jnp.asarray(x),
                               {k: jnp.asarray(v) for k, v in p.items()},
                               cfg, jnp.float32))


def _ssm_layer(arch="mamba2-1.3b"):
    cfg, params, tcfg, tp = _models(arch)
    keys = zoo._layer_keys(params, cfg)
    return cfg, {k: params[k][0] for k in keys}, tcfg, \
        {k: tp[k][0] for k in keys}


@pytest.mark.parametrize("s", [16, 48])
def test_ssd_chunked_and_block(s):
    cfg, lp, tcfg, tlp = _ssm_layer()
    rng = np.random.default_rng(3)
    b, h, p, n = 2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    A = np.asarray(lp["A"])
    jy, jst = jssm.ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)),
                               cfg.ssm_chunk)
    ty, tst = tssm.ssd_chunked(*map(_t, (xh, dt, A, Bm, Cm)),
                               cfg.ssm_chunk)
    _close_state(ty, jy, "y")
    _close_state(tst, jst, "state")
    x = (0.5 * rng.standard_normal((b, s, cfg.d_model))).astype(np.float32)
    _close_state(tssm.mamba2_block(_t(x), tlp, tcfg, torch.float32),
                 jssm.mamba2_block(jnp.asarray(x), lp, cfg, jnp.float32),
                 "block")


def test_mamba2_decode():
    cfg, lp, tcfg, tlp = _ssm_layer()
    rng = np.random.default_rng(4)
    b = 2
    ch = cfg.d_inner + 2 * cfg.ssm_state
    state = {"ssm": rng.standard_normal(
        (b, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)).astype(
            np.float32),
        "conv": rng.standard_normal((b, cfg.conv_width - 1, ch)).astype(
            np.float32)}
    for _ in range(3):
        x = (0.5 * rng.standard_normal((b, 1, cfg.d_model))).astype(
            np.float32)
        jy, jst = jssm.mamba2_decode(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()},
            lp, cfg, jnp.float32)
        ty, tst = tssm.mamba2_decode(
            _t(x), {k: _t(v) for k, v in state.items()}, tlp, tcfg,
            torch.float32)
        _close(ty, jy)
        for k in ("ssm", "conv"):
            _close_state(tst[k], jst[k], k)
        state = {k: np.asarray(v) for k, v in jst.items()}


@pytest.mark.parametrize("start", [0, 5, 14, 15, 16, 17])
def test_cache_write_clamps_like_dynamic_update_slice(start):
    """``dynamic_update_slice_in_dim`` clamps the start so the update
    fits: a write at ``max_seq - 1`` lands there, one past it lands on
    the last row too.  The port writes in place (``decode_step`` copies
    each written cache tensor once, before its layers)."""
    rng = np.random.default_rng(start)
    cache = rng.standard_normal((2, 16, 3)).astype(np.float32)
    for s in (1, 2):
        x = rng.standard_normal((2, s, 3)).astype(np.float32)
        want = jax.lax.dynamic_update_slice_in_dim(
            jnp.asarray(cache), jnp.asarray(x), start, axis=1)
        tc = _t(cache)
        got = tzoo.cache_write(tc, _t(x), start)
        assert got is tc                                   # in place
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cache_len", [15, 16])
def test_decode_step_at_the_cache_end(cache_len):
    """A decode step at ``cache_len = max_seq - 1`` and one past it, on
    a filled cache: the same clamped write and logits as the JAX step."""
    cfg, params, tcfg, tp = _models("qwen2-0.5b")
    rng = np.random.default_rng(7)
    cache = jax.tree.map(np.asarray, zoo.init_cache(cfg, 2, 16))
    cache = {k: rng.standard_normal(v.shape).astype(v.dtype)
             for k, v in cache.items()}
    tok = np.array([[3], [9]], np.int32)
    jl, jc = zoo.decode_step(params, cfg, jnp.asarray(tok),
                             {k: jnp.asarray(v) for k, v in cache.items()},
                             jnp.int32(cache_len))
    given = {k: _t(v) for k, v in cache.items()}
    tl, tc = tzoo.decode_step(tp, tcfg, _t(tok), given, cache_len)
    _close(tl, jl)
    for k in jc:
        _close_state(tc[k], jc[k], k)
        np.testing.assert_array_equal(given[k].numpy(), cache[k])  # kept


def test_embed_refuses_out_of_range_ids():
    _, _, tcfg, tp = _models("qwen2-0.5b")
    V = tcfg.vocab_padded
    for bad in (V, -1):
        with pytest.raises(ValueError, match="out of range"):
            tzoo.embed_tokens(tp, tcfg, torch.tensor([[1, bad]]),
                              torch.float32)


def test_prefill_loop_refuses_out_of_range_ids():
    """The prompt ids are checked on the host, before they reach the
    device."""
    _, _, tcfg, tp = _models("qwen2-0.5b")
    dec = tss.make_decode_step(tcfg)
    for bad in (tcfg.vocab_padded, -1):
        with pytest.raises(ValueError, match="out of range"):
            tss.prefill_loop(dec, tp, np.array([[1, bad]], np.int32),
                             tzoo.init_cache(tcfg, 1, 4, device="cpu"))


# ---------------------------------------------------------------------------
# per architecture
# ---------------------------------------------------------------------------

def _jax_stages(params, cfg, toks, fr):
    """The reference's forward, stage by stage (eager): stage name ->
    hidden state after it, and the logits."""
    f32 = jnp.float32
    out = {}
    x = zoo.embed_tokens(params, cfg, jnp.asarray(toks), f32)
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
            a, _ = zoo._attn_block(e, lp, cfg, "full", 0, f32)
            e = e + a
            e = e + zoo._mlp_block(e, lp, cfg, f32)
            out[f"enc{i}"] = e
        enc = e
    keys = zoo._layer_keys(params, cfg)
    for i in range(cfg.n_layers):
        x = zoo._decoder_block(x, {k: params[k][i] for k in keys}, cfg,
                               f32, mm, pl, enc)
        out[f"layer{i}"] = x
        if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
            sh = params["shared_attn"]
            a, _ = zoo._attn_block(x, sh, cfg, mm, pl, f32)
            x = x + a
            x = x + zoo._mlp_block(x, sh, cfg, f32)
            out[f"shared{i}"] = x
    if cfg.family == "vlm":
        x = x[:, cfg.img_tokens:]
    return out, zoo.logits_out(params, cfg, x, f32)


_FORWARD = {}


def _forward_case(arch):
    """The forward tests' inputs and the JAX stages and logits on them."""
    if arch not in _FORWARD:
        cfg, params, _, _ = _models(arch)
        toks = np.asarray(jax.random.randint(
            jax.random.PRNGKey(1), (2, 16), 0, cfg.vocab), np.int32)
        fr = _frontend(cfg, 2)
        _FORWARD[arch] = (toks, fr) + _jax_stages(params, cfg, toks, fr)
    return _FORWARD[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    cfg, params, tcfg, tp = _models(arch)
    toks, fr, stages, jlogits = _forward_case(arch)
    seen = []

    def tap(name, x):
        want = stages[name]
        assert tuple(x.shape) == want.shape, name
        _close(tzoo.logits_out(tp, tcfg, x, torch.float32),
               zoo.logits_out(params, cfg, want, jnp.float32), name)
        seen.append(name)
        return _t(want)

    got = tzoo.forward(tp, tcfg, _t(toks),
                       frontend=None if fr is None else _t(fr), tap=tap)
    assert seen == list(stages)
    _close(got, jlogits, "logits")
    # the port's own pass, untapped: the same greedy tokens as the JAX
    # forward
    free = tzoo.forward(tp, tcfg, _t(toks),
                        frontend=None if fr is None else _t(fr))
    jfree = zoo.forward(params, cfg, jnp.asarray(toks),
                        frontend=None if fr is None else jnp.asarray(fr))
    np.testing.assert_array_equal(free.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jfree, -1)))


def _kv_variants():
    out = [(a, "bfloat16") for a in ARCHS]
    out += [(a, "int8") for a in ARCHS
            if registry.get(a).family in ("dense", "vlm", "moe")][:3]
    return out


@pytest.mark.parametrize("arch,kv", _kv_variants())
def test_init_cache_matches_jax(arch, kv):
    cfg = dataclasses.replace(registry.get_smoke(arch), kv_cache_dtype=kv)
    tcfg = dataclasses.replace(treg.get_smoke(arch), kv_cache_dtype=kv)
    want = jax.tree.map(np.asarray, zoo.init_cache(cfg, 3, 20))
    got = tzoo.init_cache(tcfg, 3, 20, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("arch,kv", _kv_variants())
def test_decode_step_matches_jax(arch, kv):
    """Three decode steps from an empty cache, each side on its own
    cache: logits and caches allclose, the int8 caches equal, the
    greedy tokens equal."""
    cfg, params, tcfg, tp = _models(arch)
    cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    jc = zoo.init_cache(cfg, 2, 8)
    tc = tzoo.init_cache(tcfg, 2, 8, device="cpu")
    tok = np.array([[5], [cfg.vocab - 1]], np.int32)
    dec = jax.jit(ss.make_decode_step(cfg))
    tdec = tss.make_decode_step(tcfg)
    for step in range(3):
        jl, jc2 = zoo.decode_step(params, cfg, jnp.asarray(tok), jc,
                                  jnp.int32(step))
        tl, tc2 = tzoo.decode_step(tp, tcfg, _t(tok), tc, step)
        _close(tl, jl, f"logits step {step}")
        for k in jc2:
            if jc2[k].dtype == jnp.int8:
                np.testing.assert_array_equal(tc2[k].numpy(),
                                              np.asarray(jc2[k]))
            else:
                _close_state(tc2[k], jc2[k], f"cache {k} step {step}")
        jt, _ = dec(params, jnp.asarray(tok), jc, jnp.int32(step))
        tt, _ = tdec(tp, _t(tok), tc, step)
        assert tt.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jc, tc, tok = jc2, tc2, np.asarray(jt)


# ---------------------------------------------------------------------------
# the serving steps
# ---------------------------------------------------------------------------

def test_prefill_loop_matches_forward_and_jax():
    """Left-padded prompts through the decode cell token by token give
    ``forward``'s greedy continuation at the last position, and the
    JAX prefill loop's tokens and cache."""
    cfg, params, tcfg, tp = _models("qwen2-0.5b")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, n) for n in (3, 5, 2)]
    toks = np.zeros((3, 5), np.int32)
    for i, p in enumerate(prompts):
        toks[i, 5 - len(p):] = p
    tdec = tss.make_decode_step(tcfg)
    last, tcache, clen = tss.prefill_loop(
        tdec, tp, toks, tzoo.init_cache(tcfg, 3, 16, device="cpu"))
    assert clen == 5 and last.shape == (3, 1)
    want = tzoo.forward(tp, tcfg, _t(toks))[:, -1].argmax(-1)
    np.testing.assert_array_equal(last[:, 0].numpy(), want.numpy())
    np.testing.assert_array_equal(
        tss.make_prefill(tcfg)(tp, {"tokens": _t(toks)})[:, 0].numpy(),
        want.numpy())
    jlast, jcache, jlen = ss.prefill_loop(
        jax.jit(ss.make_decode_step(cfg)), params, toks,
        zoo.init_cache(cfg, 3, 16))
    assert int(jlen) == clen
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
    for k in jcache:
        _close_state(tcache[k], jcache[k], k)


# ---------------------------------------------------------------------------
# readings: how far the elementwise comparisons miss, per arch
# ---------------------------------------------------------------------------

def _excess(got, want):
    """``max |got - want| / (atol + rtol * |want|)``, elementwise: at
    most 1 where ``allclose`` at the stated tolerance holds."""
    got = (got.detach().cpu().numpy() if torch.is_tensor(got)
           else np.asarray(got)).astype(np.float64)
    want = np.asarray(want).astype(np.float64)
    lim = TOL["atol"] + TOL["rtol"] * np.abs(want)
    return float((np.abs(got - want) / lim).max(initial=0.0))


def _free_forward_excess(arch):
    """The untapped ``forward`` of both packages on ``test_forward``'s
    inputs: the excess of each stage's state (each side from its own
    previous stage, read through the head) and of the logits."""
    cfg, params, tcfg, tp = _models(arch)
    toks, fr, stages, jlogits = _forward_case(arch)
    ex = {}

    def tap(name, x):
        ex[name] = _excess(
            tzoo.logits_out(tp, tcfg, x, torch.float32),
            zoo.logits_out(params, cfg, stages[name], jnp.float32))
        return x

    got = tzoo.forward(tp, tcfg, _t(toks),
                       frontend=None if fr is None else _t(fr), tap=tap)
    ex["logits"] = _excess(got, jlogits)
    return ex


def _decode_excess(arch, steps=3):
    """Three decode steps from an empty cache, each package on its own
    cache (``test_decode_step_matches_jax``'s run): per step, the excess
    of the logits and of each float cache tensor."""
    cfg, params, tcfg, tp = _models(arch)
    jc = zoo.init_cache(cfg, 2, 8)
    tc = tzoo.init_cache(tcfg, 2, 8, device="cpu")
    tok = np.array([[5], [cfg.vocab - 1]], np.int32)
    out = []
    for step in range(steps):
        jl, jc = zoo.decode_step(params, cfg, jnp.asarray(tok), jc,
                                 jnp.int32(step))
        tl, tc = tzoo.decode_step(tp, tcfg, _t(tok), tc, step)
        ex = {"logits": _excess(tl, jl)}
        ex.update({k: _excess(tc[k], jc[k]) for k in jc
                   if jc[k].dtype != jnp.int8})
        out.append(ex)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    return out


# The archs whose whole untapped pass, and whose caches over three decode
# steps, hold elementwise on these inputs (``readings()``; PERF.md).
FREE_FORWARD_ARCHS = [a for a in ARCHS if a != "qwen1.5-110b"]
FREE_CACHE_ARCHS = ["qwen2-0.5b", "stablelm-3b", "whisper-large-v3",
                    "paligemma-3b", "arctic-480b", "phi3.5-moe-42b-a6.6b"]


@pytest.mark.parametrize("arch", FREE_FORWARD_ARCHS)
def test_forward_whole_pass_elementwise(arch):
    """The untapped pass of both packages, elementwise at every stage
    and on the logits (rtol 1e-4, atol 1e-5)."""
    ex = _free_forward_excess(arch)
    assert max(ex.values()) <= 1.0, ex


@pytest.mark.parametrize("arch", FREE_CACHE_ARCHS)
def test_decode_caches_elementwise(arch):
    """Three decode steps, each package on its own cache: logits and
    every float cache tensor elementwise (rtol 1e-4, atol 1e-5)."""
    for step, ex in enumerate(_decode_excess(arch)):
        assert max(ex.values()) <= 1.0, (step, ex)


def readings(archs=ARCHS):
    """Prints, per arch, the excess (``_excess``: at most 1 passes) of
    the untapped forward at each stage and on the logits, and of three
    decode steps' logits and caches."""
    for arch in archs:
        ex = _free_forward_excess(arch)
        print(f"{arch} forward, batch 2 x 16: "
              + " ".join(f"{k} {v:.3g}" for k, v in ex.items()), flush=True)
        for step, ex in enumerate(_decode_excess(arch)):
            print(f"{arch} decode step {step}: "
                  + " ".join(f"{k} {v:.3g}" for k, v in ex.items()),
                  flush=True)


if __name__ == "__main__":
    readings()

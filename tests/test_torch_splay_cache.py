"""PyTorch port, splay vocab tier: ``repro_torch.core.splay_cache``
against ``repro.core.splay_cache`` on the same seeded token streams —
the Lemma-2 heights, both refresh paths (torch pass and numpy oracle),
hysteresis, ``observe``, ``observe_serving`` on ``[E, B]`` decode
blocks with dead lanes (counts, ``m``, hot set and the token-keyed
stream state after every flush), ``lookup`` and the carried state; plus
the minitron-8b configuration and the token sampler the tier is driven
with.  Integers bit-exact, rows bit-exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import minitron_8b as jmini
from repro.core import splay_cache as jsc
from repro.core import splaylist as jsx
from repro.core import workload as jwl
from repro_torch.configs import base as tbase
from repro_torch.configs import minitron_8b as tmini
from repro_torch.core import convert
from repro_torch.core import splay_cache as tsc
from repro_torch.core import workload as twl
from torch_parity import assert_arrays_equal, assert_plane_equal, \
    assert_state_equal


def _pair(vocab, refresh_on_device=True, **kw):
    j = jsc.SplayVocabCache(vocab, device=refresh_on_device, **kw)
    t = tsc.SplayVocabCache(vocab, refresh_on_device=refresh_on_device,
                            device="cpu", **kw)
    return j, t


def assert_cache_equal(j, t, msg=""):
    np.testing.assert_array_equal(j.counts, t.counts, err_msg=msg)
    assert j.m == t.m and j.steps == t.steps, msg
    assert_arrays_equal(j.hot_ids, torch.as_tensor(t.hot_ids), msg)
    assert_arrays_equal(np.asarray(j.hot_rank), t.hot_rank, msg)
    assert (j._hot_ids_dev is None) == (t._hot_ids_dev is None), msg
    if j._hot_ids_dev is not None:
        assert_arrays_equal(j._hot_ids_dev, t._hot_ids_dev, msg)
    assert j.rng.bit_generator.state == t.rng.bit_generator.state, msg
    assert j.stream_epochs == t.stream_epochs, msg
    if j._stream_st is not None:
        assert_state_equal(j._stream_st, t._stream_st, msg)
        assert_plane_equal(j._stream_plane, t._stream_plane, msg)


def _drive(caches, vocab, steps=30, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        batch = jwl.zipf_token_ids(rng, vocab, (4, 64))
        for c in caches:
            c.observe(batch)


def _decode_blocks(vocab, n, E=4, B=16, dead=0.1, seed=0):
    """``n`` ``[E, B]`` decode-stream blocks, Zipf token ids, a share of
    dead lanes (-1), as the serving engine flushes them."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        toks = twl.zipf_token_ids(rng, vocab, (E, B))
        toks[rng.random((E, B)) < dead] = -1
        yield toks


def test_minitron_config_matches_reference():
    a, b = jmini.CONFIG, tmini.CONFIG
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for f in ("vocab_padded", "head_dim", "d_inner", "ssm_heads"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.n_params() == b.n_params()
    assert a.n_active_params() == b.n_active_params()
    assert (b.vocab_padded, b.d_model, b.hot_vocab, b.dtype) == \
        (256000, 4096, 4096, "bfloat16")
    assert b.splay_vocab_tier
    assert dataclasses.asdict(jbase.smoke_variant(a)) == \
        dataclasses.asdict(tbase.smoke_variant(b))
    assert jbase._round_up(1001, 256) == tbase._round_up(1001, 256) == 1024


@pytest.mark.parametrize("vocab", [5000, 300_000])   # below / past 2^17
def test_zipf_token_ids_match_reference(vocab):
    a = jwl.zipf_token_ids(np.random.default_rng(4), vocab, (3, 50))
    b = twl.zipf_token_ids(np.random.default_rng(4), vocab, (3, 50))
    np.testing.assert_array_equal(a, b)
    assert b.dtype == np.int32 and b.max() < min(vocab, 1 << 17)


@pytest.mark.parametrize("vocab,hot", [(3000, 128), (500, 64),
                                       (40, 64)])   # hot_size > vocab too
def test_device_refresh_matches_host_oracle_and_jax(vocab, hot):
    kw = dict(hot_size=hot, update_prob=1.0, refresh_every=10)
    jd, td = _pair(vocab, True, **kw)
    jh, th = _pair(vocab, False, **kw)
    _drive([jd, td, jh, th], vocab)
    assert_cache_equal(jd, td, "device path")
    assert_cache_equal(jh, th, "numpy oracle")
    np.testing.assert_array_equal(td.hot_ids, th.hot_ids)
    assert torch.equal(td.hot_rank, th.hot_rank)


def test_heights_host_and_device_formula_agree():
    """One Lemma-2 calibration: the host formula and its torch mirror
    agree with each other and with the reference's, across magnitudes
    and at powers of two."""
    rng = np.random.default_rng(1)
    j = jsc.SplayVocabCache(2048, hot_size=64, update_prob=1.0)
    t = tsc.SplayVocabCache(2048, hot_size=64, update_prob=1.0,
                            device="cpu")
    counts = np.zeros(2048, np.int64)
    counts[:512] = rng.integers(1, 1 << 20, 512)
    counts[:16] = [1, 2, 3, 4, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65]
    for c in (j, t):
        c.counts, c.m = counts.copy(), int(counts.sum())
    h_host = t.heights()
    np.testing.assert_array_equal(h_host, j.heights())
    c32 = np.minimum(counts, 2 ** 31 - 1).astype(np.int32)
    m32 = np.int32(min(t.m, 2 ** 31 - 1))
    h_dev = tsc._heights_device(torch.as_tensor(c32), m32)
    np.testing.assert_array_equal(h_host, h_dev.numpy())
    assert_arrays_equal(jsc._heights_device(jnp.asarray(c32), m32), h_dev)
    assert (np.diff(h_host[:512][np.argsort(counts[:512])]) >= 0).all()


def test_int_log2_floor_exact():
    q = np.array([1, 2, 3, 4, 7, 8, (1 << 53) - 1, 1 << 53,
                  (1 << 54) - 1, (1 << 60) - 1, 1 << 60, (1 << 62) - 1],
                 np.int64)
    expect = np.array([v.bit_length() - 1 for v in q.tolist()], np.int64)
    np.testing.assert_array_equal(tsc._int_log2_floor(q), expect)
    np.testing.assert_array_equal(jsc._int_log2_floor(q), expect)
    # the torch mirror over int32, where float32 would round up
    x = np.array([1, 2, 3, (1 << 24) - 1, 1 << 24, (1 << 24) + 1,
                  (1 << 30) + 1, 2 ** 31 - 1], np.int64)
    got = tsc._log2_floor_i32(torch.as_tensor(x.astype(np.int32)))
    np.testing.assert_array_equal(
        got.numpy(), [v.bit_length() - 1 for v in x.tolist()])


def test_hot_select_scores_unique_so_topk_order_is_stable():
    """``torch.topk`` promises no tie order; the score ``h·v + (v−1−id)``
    has no ties, so its order is the stable height-desc, id-asc order of
    the reference's ``lax.top_k`` and of the numpy oracle's argsort."""
    rng = np.random.default_rng(6)
    v = 2500
    h = torch.as_tensor(rng.integers(0, 12, v).astype(np.int32))
    ids = torch.arange(v, dtype=torch.int32)
    score = h * v + (v - 1 - ids)
    assert torch.unique(score).numel() == v
    top = torch.topk(score, 300, sorted=True).indices
    stable = np.argsort(-h.numpy(), kind="stable")[:300]
    np.testing.assert_array_equal(top.numpy(), stable)
    prev = torch.as_tensor(rng.random(v) < 0.05)
    a = jsc._hot_select(jnp.asarray(h.numpy()), jnp.asarray(prev.numpy()),
                        256)
    b = tsc._hot_select(h, prev, 256)
    for x, y in zip(a, b):
        assert_arrays_equal(x, y)


def test_hysteresis_keeps_residents_on_device_path():
    vocab = 1000
    caches = _pair(vocab, True, hot_size=32, update_prob=1.0,
                   refresh_every=1)
    rng = np.random.default_rng(2)
    hot = rng.choice(vocab, 32, replace=False)
    for c in caches:
        c.observe(np.repeat(hot, 64))
    first = set(caches[1].hot_ids.tolist())
    drift = np.concatenate([np.repeat(hot, 8), rng.integers(0, vocab, 256)])
    for c in caches:
        c.observe(drift)
    assert_cache_equal(*caches)
    assert len(first & set(caches[1].hot_ids.tolist())) >= 28


@pytest.mark.parametrize("refresh_on_device", [True, False])
def test_lookup_matches_table_and_jax(refresh_on_device):
    j, t = _pair(300, refresh_on_device, hot_size=32, update_prob=1.0,
                 refresh_every=1)
    rng = np.random.default_rng(1)
    batch = rng.integers(0, 300, 4096)
    j.observe(batch)
    t.observe(batch)
    assert (t._hot_ids_dev is not None) == refresh_on_device
    host = rng.normal(size=(300, 16)).astype(np.float32)
    ids = rng.integers(0, 300, (4, 16)).astype(np.int32)
    ids[0, :3] = [-1, 300, 7]                  # out of range resolves too
    a = j.lookup(jnp.asarray(host), jnp.asarray(ids))
    table = torch.as_tensor(host)
    b = t.lookup(table, torch.as_tensor(ids))
    assert b.shape == (4, 16, 16)
    assert_arrays_equal(a, b)
    np.testing.assert_array_equal(np.asarray(a), host[np.clip(
        np.where(ids < 0, ids + 300, ids), 0, 299)])
    n_buf = 32 if refresh_on_device else len(t.hot_ids)
    assert t.hot_buffer(table).shape[0] == n_buf
    assert j.hit_rate(ids[1:]) == t.hit_rate(ids[1:])


def test_cache_adapts_to_zipf():
    caches = _pair(5000, True, hot_size=256, update_prob=1.0,
                   refresh_every=10)
    _drive(caches, 5000)
    assert_cache_equal(*caches)
    ids = twl.zipf_token_ids(np.random.default_rng(9), 5000, (4, 256))
    t = caches[1]
    hit = t.hit_rate(ids)
    assert hit == caches[0].hit_rate(ids) and hit > 0.5, hit
    assert t.counts[t.hot_ids].min() >= np.sort(t.counts)[-2 * t.hot_size]


def test_empty_cache_lookup_is_plain_gather():
    j, t = _pair(50, True, hot_size=8)
    host = np.arange(50 * 3, dtype=np.float32).reshape(50, 3)
    ids = np.asarray([0, 49, -1, 60], np.int32)
    assert_arrays_equal(j.lookup(jnp.asarray(host), jnp.asarray(ids)),
                        t.lookup(torch.as_tensor(host), ids))
    assert t.hit_rate(ids) == 0.0
    t.refresh()                               # m == 0: nothing to do
    assert len(t.hot_ids) == 0


@pytest.mark.parametrize("refresh_on_device", [True, False])
def test_hot_buffer_and_empty_lookup_match_jax(refresh_on_device):
    """The hot buffer (built by B4, ``gather_rows``, on the port) against
    the JAX cache's XLA gather on both refresh paths, before and after a
    refresh; and the empty-set lookup (B4 over the table) against the JAX
    cache's, int64 and out-of-range ids included."""
    j, t = _pair(200, refresh_on_device, hot_size=16, update_prob=1.0,
                 refresh_every=1)
    rng = np.random.default_rng(4)
    host = rng.normal(size=(200, 6)).astype(np.float32)
    jt, tt = jnp.asarray(host), torch.as_tensor(host)
    assert_arrays_equal(j.hot_buffer(jt), t.hot_buffer(tt))   # [1, d] zeros
    ids = rng.integers(-250, 250, (3, 40))                    # int64
    assert_arrays_equal(j.lookup(jt, jnp.asarray(ids.astype(np.int32))),
                        t.lookup(tt, torch.as_tensor(ids)))
    batch = rng.integers(0, 200, 2048)
    j.observe(batch)
    t.observe(batch)
    assert len(t.hot_ids) == 16
    assert (t._hot_ids_dev is not None) == refresh_on_device
    buf = t.hot_buffer(tt)
    assert_arrays_equal(j.hot_buffer(jt), buf)
    assert t.hot_buffer(tt) is buf                # built once per hot set
    assert_arrays_equal(j.lookup(jt, jnp.asarray(ids.astype(np.int32))),
                        t.lookup(tt, torch.as_tensor(ids)))


@pytest.mark.parametrize("refresh_on_device", [True, False])
def test_observe_serving_matches_jax(refresh_on_device):
    """Decode-stream blocks with dead lanes through the serving loop:
    after every flush the two caches hold the same counts, ``m``, hot
    set, rng and token-keyed state and plane; the hot set refreshes
    every 8 epochs."""
    vocab = 300
    j, t = _pair(vocab, refresh_on_device, hot_size=16, update_prob=0.3,
                 refresh_every=8, seed=1)
    n_refresh = 0
    for i, toks in enumerate(_decode_blocks(vocab, 5, seed=3)):
        before = t.hot_ids.copy()
        j.observe_serving(toks)
        t.observe_serving(toks)
        assert_cache_equal(j, t, f"flush {i}")
        n_refresh += t.steps % 8 == 0
        assert int(t.counts.sum()) == t.m
        if i == 0:
            assert not len(before) and not len(t.hot_ids)
    assert n_refresh == 2 and len(t.hot_ids) == 16
    j.observe_serving(np.zeros((0, 16), np.int32))       # empty: no-op
    t.observe_serving(np.zeros((0, 16), np.int32))
    assert_cache_equal(j, t, "empty block")
    with pytest.raises(ValueError):
        t.observe_serving(np.full((2, 4), vocab, np.int32))
    with pytest.raises(ValueError):
        t.observe_serving(np.zeros(4, np.int32))


def test_cache_state_carries_across_packages():
    """A JAX cache's state handed to the port continues identically, and
    the port's own round trip loses nothing."""
    vocab = 300
    j, _ = _pair(vocab, True, hot_size=16, update_prob=0.3,
                 refresh_every=8, seed=2)
    blocks = list(_decode_blocks(vocab, 3, seed=4))
    for toks in blocks[:2]:
        j.observe_serving(toks)
    d = dict(
        {f: getattr(j, f) for f in ("vocab", "hot_size", "update_prob",
                                    "refresh_every", "seed")},
        counts=j.counts, m=j.m, steps=j.steps, hot_ids=j.hot_ids,
        hot_rank=np.asarray(j.hot_rank),
        hot_ids_dev=(None if j._hot_ids_dev is None
                     else np.asarray(j._hot_ids_dev)),
        rng_state=j.rng.bit_generator.state,
        stream_state=jsx.to_numpy(j._stream_st),
        stream_plane={f: np.asarray(getattr(j._stream_plane, f))
                      for f in j._stream_plane._fields},
        stream_epochs=j.stream_epochs)
    t = convert.cache_from_numpy(d, device="cpu")
    assert_cache_equal(j, t, "handed over")
    j.observe_serving(blocks[2])
    t.observe_serving(blocks[2])
    assert_cache_equal(j, t, "continued")
    t2 = convert.cache_from_numpy(convert.cache_to_numpy(t), device="cpu")
    assert_cache_equal(j, t2, "round trip")


def test_refresh_past_int32_takes_the_numpy_path():
    caches = _pair(64, True, hot_size=4)
    counts = np.zeros(64, np.int64)
    counts[[3, 9, 20]] = [2 ** 31, 2 ** 20, 5]
    for c in caches:
        c.counts, c.m = counts.copy(), int(counts.sum())
        c.refresh()
    assert caches[1]._hot_ids_dev is None
    assert_cache_equal(*caches)
    assert set(caches[1].hot_ids.tolist()) >= {3, 9, 20}

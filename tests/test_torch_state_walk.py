"""PyTorch port, kernel W's plain versions (``kernels/state_walk.py``)
against the JAX package's ``find_batch`` of both engines, bit for bit
in ``slot`` and ``steps``, on numpy-seeded states and queries:

* splay states after ``run_ops`` inserts and deletes and several
  ``run_contains_batch`` epochs, so that lazy nodes (``nzero > zl``),
  delete-marked keys and a bottom ``zl > 0`` after a rebuild all occur
  (``test_splay_fixtures_cover_the_walk_rules`` holds them to that);
* skip states populated through ``run_ops`` with ``sample_heights``,
  deletes included;
* queries present, absent, negative and at ``NEG_INF_32``, in batches
  of 0, 1 and 333.

Also: CPU tensors never reach the kernel's library; the refusal of a
``POS_INF_32`` key (the state untouched); the step bound ``C + L + 1``
raising ``RuntimeError`` on a hand-made cyclic ``nxt`` for both
engines; the decoding of the kernel's status word (bit flags, a refused
key raising ``ValueError`` before any other cause)."""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import skiplist as jskx
from repro.core import splaylist as jsx
from repro_torch.core import skiplist as tskx
from repro_torch.core import splaylist as tsx
from repro_torch.kernels import build
from repro_torch.kernels import state_walk
from torch_parity import assert_arrays_equal, to_torch_state

CAP, ML = 320, 10
BATCHES = (0, 1, 333)


def _splay_ops(st, kinds, keys, upd):
    st, _, _ = jsx.run_ops(st, jnp.asarray(kinds, jnp.int32),
                           jnp.asarray(keys, jnp.int32),
                           jnp.asarray(upd, bool))
    return st


def _splay_state(name):
    """``(JAX state, the keys inserted)``: 240 inserts; then ("marked")
    20 deletes and six contains epochs on live keys with update coins;
    or ("rebuilt") 80 deletes, whose hits on marked nodes fire a rebuild
    in the stream, then four epochs and 12 fresh inserts."""
    rng = np.random.default_rng({"fresh": 0, "marked": 1,
                                 "rebuilt": 2}[name])
    pool = rng.permutation(1000)[:240].astype(np.int32)
    st = _splay_ops(jsx.make(CAP, ML), np.full(240, jsx.OP_INSERT), pool,
                    rng.random(240) < 0.5)
    if name == "fresh":
        return st, pool
    gone = pool[:20] if name == "marked" else pool[::3]
    live = np.setdiff1d(pool, gone)
    st = _splay_ops(st, np.full(len(gone), jsx.OP_DELETE), gone,
                    np.zeros(len(gone), bool))
    hot = rng.choice(live, 24)
    for e in range(6 if name == "marked" else 4):
        qs = np.where(rng.random(128) < 0.7, rng.choice(hot, 128),
                      rng.choice(live, 128)).astype(np.int32)
        st, _, _ = jsx.run_contains_batch(
            st, jnp.asarray(qs), jnp.asarray(rng.random(128) < 0.6),
            aggregate=bool(e % 2))
    if name == "rebuilt":
        new = (1000 + rng.permutation(500)[:12]).astype(np.int32)
        st = _splay_ops(st, np.full(12, jsx.OP_INSERT), new,
                        rng.random(12) < 0.5)
        pool = np.concatenate([pool, new])
    return st, pool


def _skip_state(name):
    rng = np.random.default_rng({"populated": 3, "deletes": 4}[name])
    pool = rng.permutation(1000)[:240].astype(np.int32)
    hts = jskx.sample_heights(rng, 240, ML)
    st, _, _ = jskx.run_ops(jskx.make(CAP, ML),
                            jnp.full(240, jskx.OP_INSERT, jnp.int32),
                            jnp.asarray(pool), jnp.asarray(hts))
    if name == "deletes":
        gone = pool[::3]
        st, _, _ = jskx.run_ops(
            st, jnp.full(len(gone), jskx.OP_DELETE, jnp.int32),
            jnp.asarray(gone), jnp.zeros(len(gone), jnp.int32))
    return st, pool


def _queries(pool, n, seed):
    """Present, absent (inside and past the key range), negative and
    ``NEG_INF_32`` keys, ``n`` of them."""
    rng = np.random.default_rng(seed)
    edge = np.asarray([jsx.NEG_INF_32, jsx.NEG_INF_32 + 1, -1, 0,
                       jsx.POS_INF_32 - 1, 999, 1000], np.int32)
    mixed = np.concatenate([
        rng.choice(pool, 200), rng.integers(0, 1000, 80),
        rng.integers(-10 ** 6, 0, 20), rng.integers(1000, 10 ** 6, 26),
        edge]).astype(np.int32)
    return rng.permutation(mixed)[:n] if n < len(mixed) else mixed


def _to_torch_skip(js):
    return tskx.SkipState(*(torch.as_tensor(np.array(x)) for x in js))


@functools.cache
def _splay(name):
    return _splay_state(name)


def test_splay_fixtures_cover_the_walk_rules():
    """Every state holds lazy nodes (``nzero`` above the bottom) and a
    bottom ``zl > 0``; "marked" holds delete-marked keys, and "rebuilt"
    was compacted by a rebuild."""
    for name in ("fresh", "marked", "rebuilt"):
        js, _ = _splay(name)
        n = int(js.n_alloc)
        nzero = np.asarray(js.nzero)[2:n]
        assert (nzero > int(js.zl)).any(), name
        assert (nzero <= np.asarray(js.top)[2:n]).all(), name
        assert int(js.zl) > 0, name
    assert int(np.asarray(_splay("marked")[0].deleted).sum()) == 20
    assert int(_splay("rebuilt")[0].n_alloc) == 2 + 160 + 12


@pytest.mark.parametrize("n", BATCHES)
@pytest.mark.parametrize("name", ("fresh", "marked", "rebuilt"))
def test_splay_walk_matches_jax(name, n):
    js, pool = _splay(name)
    qs = _queries(pool, n, seed=n)
    want = jsx.find_batch(js, jnp.asarray(qs))
    ts = to_torch_state(js)
    got = tsx.find_batch(ts, torch.as_tensor(qs))
    plain = state_walk.splay_walk_plain(ts, torch.as_tensor(qs))
    for w, g, p, what in zip(want, got, plain, ("slot", "steps")):
        assert_arrays_equal(w, g, f"{name} n={n} {what}")
        assert_arrays_equal(w, p, f"{name} n={n} {what} (plain)")


@pytest.mark.parametrize("n", BATCHES)
@pytest.mark.parametrize("name", ("populated", "deletes"))
def test_skip_walk_matches_jax(name, n):
    js, pool = _skip_state(name)
    qs = _queries(pool, n, seed=10 + n)
    want = jskx.find_batch(js, jnp.asarray(qs))
    ts = _to_torch_skip(js)
    got = tskx.find_batch(ts, torch.as_tensor(qs))
    plain = state_walk.skip_walk_plain(ts, torch.as_tensor(qs))
    for w, g, p, what in zip(want, got, plain, ("slot", "steps")):
        assert_arrays_equal(w, g, f"{name} n={n} {what}")
        assert_arrays_equal(w, p, f"{name} n={n} {what} (plain)")


@pytest.mark.parametrize("engine", ("splay", "skip"))
def test_plain_walk_reads(engine):
    """The plain walk's ``reads`` trace: one ``(level, pred, curr)`` per
    step a lane takes, each ``curr`` the link ``nxt[level, pred]``, at
    or above the bottom and on the splay-list at or above
    ``nzero[pred]``; the walk's result is the same with the trace."""
    if engine == "splay":
        js, pool = _splay("rebuilt")
        ts, walk, bottom = to_torch_state(js), state_walk.splay_walk_plain, \
            int(js.zl)
    else:
        js, pool = _skip_state("deletes")
        ts, walk, bottom = _to_torch_skip(js), state_walk.skip_walk_plain, 0
    qs = torch.as_tensor(_queries(pool, 333, seed=5))
    reads = []
    slot, steps = walk(ts, qs, reads)
    assert_arrays_equal(np.asarray(walk(ts, qs)[0]), slot, "slot")
    assert sum(lvl.numel() for lvl, _, _ in reads) == int(steps.sum())
    for lvl, pred, curr in reads:
        assert torch.equal(ts.nxt[lvl, pred].long(), curr)
        assert bool((lvl >= bottom).all())
        if engine == "splay":
            assert bool((lvl >= ts.nzero[pred].long()).all())


def _refuse_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"the CPU path loaded the library {name}")
    monkeypatch.setattr(build, "load", refuse)


def test_cpu_tensors_never_reach_the_library(monkeypatch):
    _refuse_library(monkeypatch)
    state_walk.LAUNCHES.update(splay_walk=0, skip_walk=0)
    js, pool = _splay("marked")
    ts = to_torch_state(js)
    qs = torch.as_tensor(_queries(pool, 333, seed=5))
    tsx.find_batch(ts, qs)
    tsx.run_contains_batch(ts, qs, torch.ones(333, dtype=torch.bool),
                           aggregate=True)
    ks = tskx.make(64, 4, device="cpu")
    tskx.find_batch(ks, qs)
    tskx.run_contains_batch(ks, qs)
    assert state_walk.LAUNCHES == {"splay_walk": 0, "skip_walk": 0}


def _fields_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("engine", ("splay", "skip"))
def test_pos_inf_key_is_refused(engine):
    if engine == "splay":
        st = to_torch_state(_splay("marked")[0])
        mod = tsx
    else:
        st = _to_torch_skip(_skip_state("populated")[0])
        mod = tskx
    before = type(st)(*(x.clone() for x in st))
    for ks in ([5, tsx.POS_INF_32], [tsx.POS_INF_32]):
        with pytest.raises(ValueError, match="POS_INF_32"):
            mod.find_batch(st, ks)
    with pytest.raises(ValueError, match="POS_INF_32"):
        mod.find(st, tsx.POS_INF_32)
    assert _fields_equal(st, before)
    # the largest key below it walks to an end
    slot, _ = mod.find_batch(st, [tsx.POS_INF_32 - 1])
    assert int(slot[0]) == -1


def _cyclic(engine):
    """Slot 2 holds key 5, and head and slot 2 link to each other on
    every level: a walk for any key above 5 goes round for ever."""
    if engine == "splay":
        st = tsx.make(8, 4, device="cpu")
        st.nzero[2] = 0
        st.top[2] = 3
    else:
        st = tskx.make(8, 4, device="cpu")
    st.key[2] = 5
    st.nxt[:, 0] = 2
    st.nxt[:, 2] = 0
    return st


@pytest.mark.parametrize("engine", ("splay", "skip"))
def test_step_bound_raises_on_a_cycle(engine):
    st = _cyclic(engine)
    plain = (state_walk.splay_walk_plain if engine == "splay"
             else state_walk.skip_walk_plain)
    mod = tsx if engine == "splay" else tskx
    assert state_walk.step_bound(8, 4) == 13
    with pytest.raises(RuntimeError, match="step bound 13"):
        plain(st, torch.as_tensor([3, 10], dtype=torch.int32))
    with pytest.raises(RuntimeError, match="step bound"):
        mod.find_batch(st, [10])
    # a key below 5 descends without entering the cycle
    slot, steps = mod.find_batch(st, [3])
    assert int(slot[0]) == -1 and int(steps[0]) <= 13


def test_device_mismatch_is_refused():
    st = tsx.make(8, 4, device="cpu")
    meta = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="state on the CPU"):
        state_walk.splay_walk(st, meta)


@pytest.mark.parametrize("word,raised,match", [
    (0, None, None),
    (1, RuntimeError, "splay_walk: a lane reached the step bound"),
    (2, RuntimeError, "skip_walk: a slot index outside"),
    (3, RuntimeError, "step bound C \\+ L \\+ 1; a slot index outside"),
    (4, ValueError, "POS_INF_32"),
    (5, ValueError, "POS_INF_32"),
    (6, ValueError, "POS_INF_32"),
    (7, ValueError, "POS_INF_32"),
])
def test_status_word_decoding(word, raised, match):
    """W's status word is bit flags (1 step bound, 2 bad slot or level,
    4 refused key); a refused key raises ``ValueError`` with the host
    check's message before any other cause."""
    name = "skip_walk" if word == 2 else "splay_walk"
    err = state_walk.status_error(name, word)
    if raised is None:
        assert err is None
        return
    assert type(err) is raised
    assert re.search(match, str(err))
    if raised is ValueError:
        assert str(err) == state_walk.REFUSAL
        with pytest.raises(ValueError, match=re.escape(str(err))):
            state_walk.check_keys(torch.as_tensor([1, tsx.POS_INF_32]))

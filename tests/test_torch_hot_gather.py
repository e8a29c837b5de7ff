"""PyTorch port, vocab-tier gathers: the plain versions of B3
(``gather_hot``) and B4 (``gather_rows``) and the composed
``ops.hot_gather`` against the JAX Pallas kernels in interpret mode and
the JAX oracles, on the same seeded tables and ids — every output bit
equal (a gather is a copy: no tolerance), out-of-range ids included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import hot_gather as hg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import convert
from repro_torch.kernels import hot_gather as thg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int32": (jnp.int32, torch.int32)}


def _table(rng, v, d, name):
    if name == "int32":
        host = rng.integers(0, 1000, (v, d)).astype(np.int32)
    else:
        host = rng.normal(size=(v, d)).astype(np.float32)
    jdt, tdt = DTYPES[name]
    jt = jnp.asarray(host).astype(jdt)
    return jt, convert.table_from_numpy(np.asarray(jt), device="cpu")


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def assert_rows_equal(jax_out, torch_out, msg=""):
    """Bit equality of two row blocks of the same dtype (bfloat16
    through its 16-bit pattern)."""
    a = np.asarray(jax_out)
    b = torch_out
    assert tuple(a.shape) == tuple(b.shape), (msg, a.shape, b.shape)
    if b.dtype == torch.bfloat16:
        a, b = a.view(np.int16), b.view(torch.int16)
    b = b.numpy()
    assert a.dtype == b.dtype, (msg, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _hot_fixture(rng, v, h, d, name):
    jt, tt = _table(rng, v, d, name)
    hot_ids = rng.choice(v, h, replace=False)
    hot_rank = np.full(v, -1, np.int32)
    hot_rank[hot_ids] = np.arange(h)
    jbuf = jt[jnp.asarray(hot_ids)]
    tbuf = tt[torch.as_tensor(hot_ids)]
    return jt, tt, jbuf, tbuf, hot_rank


def _out_of_range(v):
    return np.asarray([-1, -v, -v - 1, -3 * v, v, v + 2, 10 * v,
                       2 ** 31 - 1, -(2 ** 31)], np.int32)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("v,h,d,q", [(500, 32, 16, 64),
                                     (2048, 128, 64, 256),
                                     (301, 17, 37, 33)])   # odd d and q
def test_hot_gather_sweep(name, v, h, d, q):
    rng = np.random.default_rng(v + d)
    jt, tt, jbuf, tbuf, hot_rank = _hot_fixture(rng, v, h, d, name)
    ids = rng.integers(0, v, q).astype(np.int32)
    a = jops.hot_gather(jt, jbuf, jnp.asarray(hot_rank), jnp.asarray(ids))
    b = tops.hot_gather(tt, tbuf, torch.as_tensor(hot_rank),
                        torch.as_tensor(ids))
    assert_rows_equal(a, b, "hot_gather")
    assert_rows_equal(jref.hot_gather_ref(jt, jbuf, jnp.asarray(hot_rank),
                                          jnp.asarray(ids)),
                      tref.hot_gather_ref(tt, tbuf,
                                          torch.as_tensor(hot_rank),
                                          torch.as_tensor(ids)), "ref")
    assert torch.equal(_bits(b), _bits(tt[torch.as_tensor(ids).long()]))


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("n,d,q", [(64, 8, 16), (512, 128, 64),
                                   (97, 13, 1)])
def test_gather_rows_and_hot_match_pallas(name, n, d, q):
    rng = np.random.default_rng(d + q)
    jt, tt = _table(rng, n, d, name)
    ids = rng.integers(0, n, q).astype(np.int32)
    for jf, tf in ((hg.gather_rows, thg.gather_rows),
                   (hg.gather_hot, thg.gather_hot)):
        assert_rows_equal(jf(jt, jnp.asarray(ids)),
                          tf(tt, torch.as_tensor(ids)), jf.__name__)
    assert_rows_equal(jref.gather_rows_ref(jt, jnp.asarray(ids)),
                      tref.gather_rows_ref(tt, torch.as_tensor(ids)), "ref")


@pytest.mark.parametrize("which", ["gather_rows", "gather_hot",
                                   "hot_gather"])
def test_out_of_range_ids_match_pallas(which):
    """A negative id wraps once and what is still out of range clamps,
    in the Pallas kernels, the JAX oracle and the port alike."""
    rng = np.random.default_rng(5)
    v, h, d = 40, 8, 12
    jt, tt, jbuf, tbuf, hot_rank = _hot_fixture(rng, v, h, d, "float32")
    ids = np.concatenate([_out_of_range(v),
                          rng.integers(0, v, 7).astype(np.int32)])
    if which == "hot_gather":
        a = jops.hot_gather(jt, jbuf, jnp.asarray(hot_rank),
                            jnp.asarray(ids))
        b = tops.hot_gather(tt, tbuf, torch.as_tensor(hot_rank),
                            torch.as_tensor(ids))
    else:
        a = getattr(hg, which)(jt, jnp.asarray(ids))
        b = getattr(thg, which)(tt, torch.as_tensor(ids))
    assert_rows_equal(a, b, which)
    assert_rows_equal(jt[jnp.asarray(ids)], b, "jnp indexing")
    # the wrap-once-then-clamp rule, spelled out
    want = np.asarray([v - 1, 0, 0, 0, v - 1, v - 1, v - 1, v - 1, 0])
    got = tref.take_index(torch.as_tensor(_out_of_range(v)), v).numpy()
    np.testing.assert_array_equal(got, want)


def test_empty_and_degenerate_batches():
    rng = np.random.default_rng(2)
    jt, tt = _table(rng, 16, 4, "int32")
    for f in (thg.gather_rows, thg.gather_hot):
        out = f(tt, torch.zeros(0, dtype=torch.int32))
        assert out.shape == (0, 4) and out.dtype == torch.int32
    # (the Pallas grid cannot be empty; the JAX oracle can)
    assert_rows_equal(jref.gather_rows_ref(jt, jnp.zeros(0, jnp.int32)),
                      thg.gather_rows(tt, torch.zeros(0, dtype=torch.int32)))
    with pytest.raises(ValueError):
        thg.gather_rows(tt, torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        thg.gather_rows(tt, torch.zeros(3))
    with pytest.raises(ValueError):
        thg.gather_rows(tt[:0], torch.zeros(3, dtype=torch.int32))


def test_table_from_numpy_is_bit_exact():
    rng = np.random.default_rng(3)
    host = rng.normal(size=(33, 7)).astype(np.float32)
    jt = jnp.asarray(host).astype(jnp.bfloat16)
    tt = convert.table_from_numpy(np.asarray(jt), device="cpu")
    assert tt.dtype == torch.bfloat16
    assert_rows_equal(jt, tt)
    # casting float32 to bfloat16 rounds the same way in both packages
    assert_rows_equal(jt, convert.table_from_numpy(
        host, dtype=torch.bfloat16, device="cpu"))


def _two_tier(rng, v, nr, h, d, name, bad_ranks=0):
    """A table of ``v`` rows, a hot-rank map of ``nr`` entries (``h`` of
    them hot, ``bad_ranks`` more pointing past the buffer) and the hot
    buffer of ``h`` rows the map's hot entries name."""
    jt, tt = _table(rng, v, d, name)
    hot_rank = np.full(nr, -1, np.int32)
    slots = rng.choice(nr, h, replace=False)
    hot_rank[slots] = np.arange(h)
    free = np.nonzero(hot_rank < 0)[0]
    hot_rank[rng.choice(free, bad_ranks, replace=False)] = \
        h + 7 * np.arange(bad_ranks)                # clamp to row h - 1
    rows = np.minimum(slots, v - 1)
    return (jt, tt, jt[jnp.asarray(rows)], tt[torch.as_tensor(rows)],
            hot_rank)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("case", ["mixed", "all-hot", "all-cold",
                                  "out-of-range", "rank-map-shorter",
                                  "rank-map-longer", "ranks-past-h",
                                  "int64-ids", "q1-odd-d"])
def test_fused_hot_gather_matches_jax(name, case):
    """The fused two-tier gather (``hot_gather.hot_gather`` and
    ``ops.hot_gather``) against the JAX ``ops.hot_gather`` over the
    Pallas kernels in interpret mode, bit for bit, on the edge cases of
    its index rule."""
    rng = np.random.default_rng(len(case))
    v, h, d, q = 120, 16, 12, 48
    nr = {"rank-map-shorter": v // 2, "rank-map-longer": 2 * v}.get(case, v)
    if case == "q1-odd-d":
        d, q = 37, 1
    jt, tt, jbuf, tbuf, hot_rank = _two_tier(
        rng, v, nr, h, d, name, bad_ranks=5 if case == "ranks-past-h" else 0)
    hot = np.nonzero(hot_rank >= 0)[0]
    pool = {"all-hot": hot, "all-cold": np.nonzero(hot_rank < 0)[0]}.get(
        case, np.arange(nr))
    ids = rng.choice(pool, q).astype(np.int64)
    if case in ("out-of-range", "rank-map-shorter", "rank-map-longer"):
        ids = np.concatenate([_out_of_range(v), ids])
    if case == "int64-ids":                   # the low 32 bits count
        ids = ids + (rng.integers(-2 ** 20, 2 ** 20, ids.shape) << 32)
        ids[:3] = [2 ** 32 - 1, -(2 ** 32) + 5, 2 ** 40 + v + 3]
    tids = torch.as_tensor(ids if case == "int64-ids" else
                           ids.astype(np.int32))
    a = jops.hot_gather(jt, jbuf, jnp.asarray(hot_rank),
                        jnp.asarray(ids.astype(np.int32)))
    before = dict(thg.LAUNCHES)
    for fn in (thg.hot_gather, tops.hot_gather):
        assert_rows_equal(a, fn(tt, tbuf, torch.as_tensor(hot_rank), tids),
                          f"{fn.__module__} {case}")
    assert thg.LAUNCHES == before             # CPU: the plain version
    if case in ("mixed", "all-hot", "all-cold", "int64-ids", "q1-odd-d"):
        # a consistent hot set: the gather is table[ids]
        assert_rows_equal(jt[jnp.asarray(ids.astype(np.int32))],
                          thg.hot_gather(tt, tbuf, torch.as_tensor(
                              hot_rank), tids), "table[ids]")


def test_fused_hot_gather_empty_batch_and_refusals():
    """q = 0 against the oracle (the Pallas grid cannot be empty), and
    the operands the kernel does not take."""
    rng = np.random.default_rng(8)
    _, tt, _, tbuf, hot_rank = _two_tier(rng, 30, 30, 4, 5, "int32")
    rank = torch.as_tensor(hot_rank)
    none = torch.zeros(0, dtype=torch.int64)
    for fn in (thg.hot_gather, tops.hot_gather):
        out = fn(tt, tbuf, rank, none)
        assert out.shape == (0, 5) and out.dtype == torch.int32
        assert torch.equal(out, tref.hot_gather_ref(tt, tbuf, rank, none))
    ids = torch.as_tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError):
        thg.hot_gather(tt, tbuf.float(), rank, ids)      # dtypes differ
    with pytest.raises(ValueError):
        thg.hot_gather(tt, tbuf[:, :4], rank, ids)       # widths differ
    with pytest.raises(ValueError):
        thg.hot_gather(tt, tbuf, rank[:0], ids)          # no rank map
    with pytest.raises(ValueError):
        thg.hot_gather(tt, tbuf, rank, ids.float())
    with pytest.raises(ValueError):
        thg.hot_gather(tt, tbuf, rank, ids[None])


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 4096, "bulk"),            # minitron-8b rows, 8192 B
    (torch.float32, 4, "bulk"),
    (torch.float32, 1002, "vector8"),
    (torch.float32, 1001, "vector4"),
    (torch.bfloat16, 1001, "vector2"),
    (torch.uint8, 37, "vector1")])
def test_copy_path_follows_row_length(dtype, d, want):
    t = torch.zeros((3, d), dtype=dtype)
    out = torch.empty_like(t)
    assert thg.copy_path(d * t.element_size(), t, out) == want


def test_copy_path_follows_base_alignment():
    flat = torch.zeros(3 * 4096 + 2, dtype=torch.float32)
    aligned = flat[:3 * 4096].view(3, 4096)
    shifted = flat[1:3 * 4096 + 1].view(3, 4096)   # base 4 bytes off
    assert thg.copy_path(4 * 4096, aligned) == "bulk"
    assert thg.copy_path(4 * 4096, shifted) == "vector4"
    assert thg.copy_path(4 * 4096, aligned, shifted) == "vector4"

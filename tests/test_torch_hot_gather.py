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

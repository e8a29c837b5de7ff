"""PyTorch port, the redesigned kernels F and B5 held on the CPU.

F: the weighted fold on lists that are mostly zero weights (what the
kernel's ballot skips) equals the fold of their ``w > 0`` subset and
the JAX ``run_contains_batch`` state, field by field, for int32 and
int64 counts.  B5: the triple counted without the reference's row skip
(what the cluster kernel computes) equals the JAX ``_kernel_full`` in
interpret mode and the port's plain version on hot batches where whole
query blocks are found above the bottom row; and the kernel's launch
plan (``splay_search.full_plan``: cluster size, column slices, staging
panels) covers every plane exactly, within a block's shared memory.
The pointer-chase calibration printed beside F's walk refuses the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import splaylist as sx
from repro.kernels import splay_search as ssk
from repro_torch.core import level_arrays as tla
from repro_torch.core import splaylist as tsx
from repro_torch.core import workload as twl
from repro_torch.kernels import calibrate
from repro_torch.kernels import fold
from repro_torch.kernels import splay_search as tssk
from torch_parity import assert_arrays_equal, to_torch_state

CAP, ML, N_KEYS, B = 512, 12, 300, 400
COUNT_FIELDS = ("hits", "selfhits", "m", "dhits")


def _jax_prefilled(seed):
    rng = np.random.default_rng(seed)
    pool = rng.permutation(4 * N_KEYS)[:N_KEYS].astype(np.int32)
    js, _, _ = sx.run_ops(sx.make(CAP, ML),
                          jnp.full((N_KEYS,), sx.OP_INSERT, jnp.int32),
                          jnp.asarray(pool), jnp.ones((N_KEYS,), bool))
    return js, pool, rng


def _as_count(ts, count_dtype):
    return ts._replace(**{f: getattr(ts, f).to(count_dtype)
                          for f in COUNT_FIELDS})


def _assert_values_equal(js, ts, msg):
    """Every field equal by value (an int64 port state against the JAX
    int32 one: the counts stay far below 2^31)."""
    a, b = sx.to_numpy(js), tsx.to_numpy(ts)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f].astype(a[f].dtype),
                                      err_msg=f"{msg} {f}")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("aggregate", [True, False])
@pytest.mark.parametrize("count_dtype", [torch.int32, torch.int64])
def test_sparse_weighted_fold_equals_subset_and_jax(count_dtype, aggregate,
                                                    seed):
    js, pool, rng = _jax_prefilled(seed)
    keys = np.concatenate([rng.choice(pool, B - 40),
                           rng.integers(5000, 6000, 40)]).astype(np.int32)
    upd = rng.random(B) < 0.04
    want_st, want_res, want_steps = sx.run_contains_batch(
        js, jnp.asarray(keys), jnp.asarray(upd), aggregate=aggregate)

    ts = _as_count(to_torch_state(js), count_dtype)
    entries, res, steps = tsx.fold_entries(ts, keys, upd, aggregate)
    w = entries[1]
    assert float((w == 0).float().mean()) >= 0.9
    full, sub = tsx.clone(ts), tsx.clone(ts)
    fold.fold_weighted(full, *entries)
    keep = w > 0
    fold.fold_weighted(sub, *(x[keep] for x in entries))
    for f, a, b in zip(tsx.SplayState._fields, full, sub):
        assert torch.equal(a, b), f
    _assert_values_equal(want_st, tsx._maybe_rebuild(full),
                         f"{count_dtype} aggregate={aggregate}")
    assert_arrays_equal(want_res, res, "results")
    assert_arrays_equal(want_steps, steps, "steps")


# ---------------------------------------------------------------------------
# B5 without the row skip
# ---------------------------------------------------------------------------

def _full_no_skip(keys, qs):
    """The cluster kernel's arithmetic: every row counted for every
    query, then hit / first level / bottom rank."""
    keys = np.asarray(keys, np.int64)
    q = np.asarray(qs, np.int64)
    n_levels = keys.shape[0]
    found = np.zeros(q.shape, bool)
    level = np.full(q.shape, n_levels, np.int32)
    for r in range(n_levels):
        cnt = (keys[r][None, :] <= q[:, None]).sum(1)
        hit = (cnt > 0) & (keys[r][np.maximum(cnt - 1, 0)] == q)
        level = np.where(hit & ~found, r, level).astype(np.int32)
        found |= hit
    return found, (cnt - 1).astype(np.int32), level


def _hot_plane(width, n_levels, nq, alpha, seed):
    """A Zipf plane and a batch whose first half is drawn from a hot
    row (found high up: whole blocks resolve above the bottom row) and
    whose second half mixes misses in."""
    keys, heights, _ = twl.zipf_level_fixture(width, alpha, 16, seed=seed)
    plane = tla.build(keys, heights, min_levels=n_levels)
    m = plane.keys
    rng = np.random.default_rng(seed)
    hot_row = next(r for r in range(m.shape[0])
                   if (m[r] != tssk.PAD_KEY).sum() >= 2)
    hot = m[hot_row][m[hot_row] != tssk.PAD_KEY]
    live = m[-1][m[-1] != tssk.PAD_KEY]
    half = nq // 2
    qs = np.concatenate([rng.choice(hot, half), rng.choice(live, nq - half)])
    qs[half::7] = rng.integers(0, 40 * width, len(qs[half::7]))
    return m, qs.astype(np.int32)


@pytest.mark.parametrize("width,n_levels,nq,qb,alpha", [
    (4096, 8, 512, 128, 1.2),
    (2048, 6, 333, 64, 1.0),
    (1031, 5, 256, 32, 1.4),
    (256, 6, 100, 16, 0.8)])
def test_full_without_the_row_skip_matches_pallas(width, n_levels, nq, qb,
                                                  alpha):
    m, qs = _hot_plane(width, n_levels, nq, alpha, seed=width + nq)
    want = ssk._splay_search_full_arrays(jnp.asarray(m), jnp.asarray(qs),
                                         query_block=qb, interpret=True)
    got = _full_no_skip(m, qs)
    plain = tssk.splay_search_full(torch.as_tensor(m), torch.as_tensor(qs),
                                   query_block=qb)
    for name, a, b, c in zip(("found", "rank", "level"), want, got, plain):
        assert_arrays_equal(a, torch.as_tensor(b), name)
        assert_arrays_equal(a, c, name)
    # the reference's rule fired: some whole block was found above the
    # bottom row, so the plain version skipped rows the kernel counts
    pad = (-nq) % qb
    f = np.concatenate([got[0], np.ones(pad, bool)]).reshape(-1, qb)
    lv = np.concatenate([got[2], np.zeros(pad, np.int32)]).reshape(-1, qb)
    skipped = f.all(1) & (lv.max(1) + 1 < n_levels - 1)
    assert skipped.any() and not skipped.all()


# ---------------------------------------------------------------------------
# B5's launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 3, 4, 20, 33, 1031, 4092, 16384,
                                   131072, 4 * 2 ** 20])
@pytest.mark.parametrize("n_levels", [1, 24, 64])
def test_full_plan_covers_the_plane(width, n_levels):
    plan = tssk.full_plan(width, n_levels)
    assert 1 <= plan.cluster <= 8
    assert plan.slice % 4 == 0 and plan.slice >= 4
    assert (plan.cluster - 1) * plan.slice < width <= plan.cluster * plan.slice
    assert plan.pcols % 4 == 0 and 4 <= plan.pcols <= plan.slice
    assert 1 <= plan.prows <= n_levels
    assert plan.smem == (tssk._full_fixed_smem(n_levels)
                         + 4 * plan.prows * plan.pcols)
    assert plan.smem <= tssk._SMEM_BLOCK
    assert plan.bulk == (width % 4 == 0)
    assert not tssk.full_plan(width, n_levels, aligned=False).bulk


def test_full_plan_main_path_and_wide_planes():
    # the full-search path (W = 16384, L = 24): eight CTAs of 2048
    # columns, every row staged at once (192 KB of the 227 KB)
    assert tssk.full_plan(16384, 24)[:5] == (8, 2048, 2048, 24, True)
    # B1's plane width: rows in panels of 3
    plan = tssk.full_plan(131072, 24)
    assert (plan.cluster, plan.slice, plan.pcols, plan.prows) == \
        (8, 16384, 16384, 3)
    # a slice wider than a block holds: column panels of one row
    plan = tssk.full_plan(4 * 2 ** 20, 24)
    assert plan.prows == 1 and plan.pcols < plan.slice
    for bad in ((0, 4), (16, 0)):
        with pytest.raises(ValueError):
            tssk.full_plan(*bad)


@pytest.mark.parametrize("width,n_levels", [(1031, 5), (33, 3), (4092, 9)])
def test_full_plan_partition_sums_to_the_count(width, n_levels):
    """The kernel's partition, emulated: each CTA's column slice, in
    panels, counted in 16 column parts (int4 words, then the ragged
    tail) and summed, gives every row's full count."""
    rng = np.random.default_rng(width)
    m = np.sort(rng.integers(-50, 10 * width, (n_levels, width)), axis=1)
    qs = rng.integers(-60, 10 * width + 10, 40)
    plan = tssk.full_plan(width, n_levels)
    cnt = np.zeros((n_levels, qs.size), np.int64)
    for cta in range(plan.cluster):
        c0, c1 = cta * plan.slice, min(width, (cta + 1) * plan.slice)
        for cc in range(c0, c1, plan.pcols):
            ncol = min(plan.pcols, c1 - cc)
            for r0 in range(0, n_levels, plan.prows):
                for r in range(r0, min(n_levels, r0 + plan.prows)):
                    panel = m[r, cc:cc + ncol]
                    n4 = ncol // 4
                    for part in range(16):
                        for j in range(part, n4, 16):
                            cnt[r] += (panel[4 * j:4 * j + 4, None]
                                       <= qs[None, :]).sum(0)
                    cnt[r] += (panel[4 * n4:, None] <= qs[None, :]).sum(0)
    np.testing.assert_array_equal(cnt, (m[:, None, :] <= qs[None, :, None])
                                  .sum(2))


def test_pointer_chase_needs_a_card():
    with pytest.raises(ValueError, match="only on a CUDA device"):
        calibrate.chase_ns(1024, 100, device="cpu")

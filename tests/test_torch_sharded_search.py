"""PyTorch port, the width-sharded search and ordered ops: the port on
gloo worlds of 1, 2 and 4 CPU ranks (``launch.spmd``) against the JAX
package on meshes of 1, 2 and 4 forced host devices, built with
``jax.sharding.Mesh`` (Auto axes), on the same seeded inputs
(``mesh_cases.search_suite``).  Bit for bit: the routed, masked,
forced-spill (capacity 3) and pipelined (B2) searches with their
``RouteStats``; the dispatch seam (auto, forced gather); a single-owner
batch; planes with empty upper rows, all empty, and of an indivisible
width; no queries; boundary-straddling windows, block-first keys twice,
the int32 extremes and ``q % S != 0``; a mass-split (segmented) plane,
routed and masked, on its resident sub-planes; every ordered op on a
lanes-split and a mass-split plane.  Every rank returns the same
answer.  Then the plane helpers against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_cases as mc
from repro.parallel import sharding as jshd
from repro.train import elastic as jelastic
from repro_torch.core import device_index as tdix
from repro_torch.kernels import splay_search as tssk
from repro_torch.parallel import sharding as tshd
from repro_torch.train import elastic as telastic

SUITE = "search"
CASES = mc.cases_of(SUITE)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return mc.run_both(SUITE, str(tmp_path_factory.mktemp("mesh")))


@pytest.mark.parametrize("S,case", CASES,
                         ids=[f"S{S}-{c}" for S, c in CASES])
def test_sharded_search_matches_jax_mesh(both, S, case):
    ref, port = both
    mc.assert_same(ref[S][case], port[S][0][case], f"S={S} {case}")
    for r in range(1, S):
        mc.assert_same(port[S][0][case], port[S][r][case],
                       f"S={S} {case} rank {r}")


@pytest.mark.parametrize("S", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_mass_split_bounds_matches_jax(S, seed):
    rng = np.random.default_rng(seed)
    wl = 16
    total = int(rng.integers(S * wl // 2, S * wl + 1))
    mass = np.where(np.arange(S * wl) < total,
                    1 + rng.zipf(1.3, S * wl).clip(max=2 ** 16), 0)
    cum = np.cumsum(mass).astype(np.int32)
    ref = jshd.mass_split_bounds(jnp.asarray(cum), total, S, wl)
    got = tshd.mass_split_bounds(torch.as_tensor(cum), total, S, wl)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert got.dtype == torch.int32


def test_suffix_min_bounds_and_specs_match_jax():
    firsts = np.array([-7, 40, 2 ** 31 - 1, 90, 2 ** 31 - 1], np.int32)
    np.testing.assert_array_equal(
        np.asarray(jshd.suffix_min_bounds(jnp.asarray(firsts))),
        tshd.suffix_min_bounds(torch.as_tensor(firsts)).numpy())
    from repro.core import device_index as jdix
    ref = jshd.index_plane_specs(jdix.DeviceLevelArrays)
    got = tshd.index_plane_specs(tdix.DeviceLevelArrays)
    assert [tuple(s) for s in ref] == [tuple(s) for s in got]


@pytest.mark.parametrize("n,mp,pod", [(4, 2, False), (8, 2, True),
                                      (3, 4, False), (6, 2, True)])
def test_viable_grid_matches_jax(n, mp, pod):
    assert telastic.viable_grid(n, mp, pod) == jelastic.viable_grid(
        n, mp, pod)


def test_meshless_fallbacks_and_mesh_check():
    """Without a mesh the sharded entry points are the replicated ones
    (stats: no spill, one pseudo-shard); a mesh that is not a
    ``sharding.Mesh`` is refused."""
    keys, hts = mc.skewed_fixture(60, 64, 6, seed=1)
    plane = tdix.build_device(torch.as_tensor(keys), torch.as_tensor(hts), 6)
    q = torch.as_tensor(np.arange(-3, 250, 5, dtype=np.int32))
    ref = tssk.splay_search(plane, q)
    f, r, lv, st = tssk.splay_search_sharded(plane, q, return_stats=True)
    for a, b in zip(ref, (f, r, lv)):
        assert torch.equal(a, b)
    assert int(st.spill) == 0 and st.occupancy.tolist() == [q.shape[0]]
    assert int(st.assembled) == 0
    assert tshd.plane_width_mesh(plane) is None
    assert tshd.shard_index_plane(plane) is plane
    assert tshd.gather_index_plane(plane) is plane
    for a, b in zip(tssk.splay_search(plane, q, sharded=True), ref):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="sharding.Mesh"):
        tssk.splay_search_sharded(plane, q, mesh=object())

"""PyTorch port, the width-sharded refresh: the port on gloo worlds of
1, 2 and 4 CPU ranks against the JAX package on meshes of 1, 2 and 4
forced host devices (``jax.sharding.Mesh``, Auto axes), on the same
seeded states and op streams (``mesh_cases.refresh_suite``).  Bit for
bit, every field of the gathered plane (``slots`` on every lane, the
residency fields, ``local_ok``), the overflow count, the segmented
verdict and the inferred segment count: four churn epochs under
``split="lanes"`` and four under ``split="mass"`` (one of them a hot set
that skews the hit counters), an insert burst past ``max_new`` and past
the width, a slot-compacted (stale slot map) state, a plane emptied and
refilled, an indivisible width (the replicated fallback), the audit of
a lanes and of a 4-segment plane (also after bit-flips) with the segment
count inferred from the layout, and ``to_host``.  Every rank returns
the same planes."""

import pytest

import mesh_cases as mc

SUITE = "refresh"
CASES = mc.cases_of(SUITE)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return mc.run_both(SUITE, str(tmp_path_factory.mktemp("mesh")))


@pytest.mark.parametrize("S,case", CASES,
                         ids=[f"S{S}-{c}" for S, c in CASES])
def test_sharded_refresh_matches_jax_mesh(both, S, case):
    ref, port = both
    mc.assert_same(ref[S][case], port[S][0][case], f"S={S} {case}")
    for r in range(1, S):
        mc.assert_same(port[S][0][case], port[S][r][case],
                       f"S={S} {case} rank {r}")

"""Shared fixtures/helpers for the test suite."""

import jax.numpy as jnp
import numpy as np

from repro.core import splaylist as sx


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels); skipped "
        "without one")


def seed_splay_state(pool, cap=256, ml=12):
    """A splay-list state seeded by inserting ``pool`` in order (the
    common differential-test fixture; ``benchmarks/sharded_refresh_probe``
    carries its own copy by design — it must stay runnable as a
    standalone subprocess)."""
    st = sx.make(capacity=cap, max_level=ml)
    st, _, _ = sx.run_ops(
        st, jnp.full((len(pool),), sx.OP_INSERT, jnp.int32),
        jnp.asarray(np.asarray(pool, np.int32)),
        jnp.ones((len(pool),), bool))
    return st

"""Shared helpers of the PyTorch-port parity tests: states and planes
carried between the two packages as numpy arrays, and field-by-field
bit-exact comparisons."""

import jax.numpy as jnp
import numpy as np

from repro.core import splaylist as sx
from repro_torch.core import convert
from repro_torch.core import splaylist as tsx

PLANE_FIELDS = ("keys", "widths", "heights", "rank_map", "bot_rank",
                "local_bot", "local_heights", "local_live", "local_ok")


def to_torch_state(js):
    return convert.state_from_numpy(sx.to_numpy(js), device="cpu")


def to_jax_state(ts):
    return sx.SplayState(**{f: jnp.asarray(v)
                            for f, v in tsx.to_numpy(ts).items()})


def assert_state_equal(js, ts, msg=""):
    a, b = sx.to_numpy(js), tsx.to_numpy(ts)
    assert set(a) == set(b)
    for f in a:
        assert a[f].dtype == b[f].dtype, (msg, f, a[f].dtype, b[f].dtype)
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{msg} {f}")


def assert_plane_equal(jp, tp, msg=""):
    """Every field bit-equal; ``slots`` on the bottom row's live lanes
    only (pad lanes are unspecified in both packages)."""
    for f in PLANE_FIELDS:
        a = np.asarray(getattr(jp, f))
        b = getattr(tp, f).cpu().numpy()
        assert a.dtype == b.dtype, (msg, f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {f}")
    w_bot = int(np.asarray(jp.widths)[-1])
    np.testing.assert_array_equal(
        np.asarray(jp.slots)[:w_bot], tp.slots.cpu().numpy()[:w_bot],
        err_msg=f"{msg} slots")


def assert_arrays_equal(a, b, msg=""):
    a = np.asarray(a)
    b = b.cpu().numpy() if hasattr(b, "cpu") else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        (msg, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=msg)

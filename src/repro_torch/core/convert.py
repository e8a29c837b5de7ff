"""State carried across the two packages as numpy arrays, so that both
start a test from the same state.

``state_from_numpy`` takes the dict that ``repro.core.splaylist.
to_numpy`` (or this package's ``splaylist.to_numpy``) returns;
``plane_from_numpy`` takes the ``DeviceLevelArrays`` fields as numpy
arrays — a mapping, or any NamedTuple of them.  ``table_from_numpy``
takes an embedding table (bfloat16 as the ``ml_dtypes`` array that
``np.asarray`` makes of a JAX array), ``level_arrays_from_numpy`` the
``LevelArrays`` fields, and ``cache_from_numpy`` the dict
:func:`cache_to_numpy` returns, and ``params_from_numpy`` a model's
parameter tree (nested dicts of arrays, as ``jax.tree.map(np.asarray,
params)`` gives it).  The inverses return the same forms.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import device_index as dix
from repro_torch.core import level_arrays as la
from repro_torch.core import splaylist as sx
from repro_torch.core.splay_cache import SplayVocabCache


def _fields(obj) -> dict:
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def state_from_numpy(d, device="cuda") -> sx.SplayState:
    dev = sx._device(device)
    d = _fields(d)
    return sx.SplayState(*(torch.as_tensor(np.array(d[f]), device=dev)
                           for f in sx.SplayState._fields))


def state_to_numpy(st: sx.SplayState) -> dict:
    return sx.to_numpy(st)


def plane_from_numpy(fields, device="cuda") -> dix.DeviceLevelArrays:
    dev = sx._device(device)
    d = _fields(fields)
    return dix.DeviceLevelArrays(*(
        torch.as_tensor(np.array(d[f], np.int32), device=dev)
        for f in dix.DeviceLevelArrays._fields))


def plane_to_numpy(plane: dix.DeviceLevelArrays) -> dict:
    return {f: getattr(plane, f).cpu().numpy() for f in plane._fields}


def table_from_numpy(arr, dtype=None, device="cuda") -> torch.Tensor:
    """An embedding table as a tensor, bit for bit.  A bfloat16 array
    (numpy has no bfloat16 of its own; ``ml_dtypes`` gives it one) goes
    through its 16-bit pattern, which is exact; ``dtype`` then casts."""
    dev = sx._device(device)
    a = np.ascontiguousarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    if dtype is not None:
        t = t.to(dtype)
    return t.to(dev)


def params_from_numpy(tree, device="cuda") -> dict:
    """A model's parameter tree as tensors on ``device``: every name,
    nesting (zamba2's ``shared_attn``), shape and dtype kept, bfloat16
    arrays bit for bit."""
    dev = sx._device(device)
    return {k: (params_from_numpy(v, dev) if isinstance(v, dict)
                else table_from_numpy(v, device=dev))
            for k, v in tree.items()}


def tensor_to_numpy(v: torch.Tensor) -> np.ndarray:
    """A host copy of ``v`` as a numpy array, never sharing its memory
    (a CPU tensor is copied too).  bfloat16 comes back as an
    ``ml_dtypes`` bfloat16 array, bit for bit."""
    h = v.detach().to("cpu", copy=True)
    if h.dtype == torch.bfloat16:
        import ml_dtypes
        return h.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return h.numpy()


def params_to_numpy(params) -> dict:
    """The inverse of :func:`params_from_numpy` (each tensor through
    :func:`tensor_to_numpy`)."""
    return {k: (params_to_numpy(v) if isinstance(v, dict)
                else tensor_to_numpy(v))
            for k, v in params.items()}


def level_arrays_from_numpy(fields) -> la.LevelArrays:
    d = _fields(fields)
    return la.LevelArrays(*(np.array(d[f], np.int32)
                            for f in la.LevelArrays._fields))


_CACHE_CONFIG = ("vocab", "hot_size", "update_prob", "refresh_every",
                 "seed")


def cache_to_numpy(cache: SplayVocabCache) -> dict:
    """Everything a :class:`SplayVocabCache` carries from one call to
    the next, as numpy arrays and plain values (the hot buffer is
    derived and left out)."""
    def host(t):
        return None if t is None else t.cpu().numpy()
    return dict(
        {f: getattr(cache, f) for f in _CACHE_CONFIG},
        counts=cache.counts.copy(), m=cache.m, steps=cache.steps,
        hot_ids=cache.hot_ids.copy(), hot_rank=host(cache.hot_rank),
        hot_ids_dev=host(cache._hot_ids_dev),
        rng_state=cache.rng.bit_generator.state,
        stream_state=(None if cache._stream_st is None
                      else state_to_numpy(cache._stream_st)),
        stream_plane=(None if cache._stream_plane is None
                      else plane_to_numpy(cache._stream_plane)),
        stream_epochs=cache.stream_epochs)


def cache_from_numpy(d, refresh_on_device: bool = True,
                     device="cuda") -> SplayVocabCache:
    """A cache that continues from the dict :func:`cache_to_numpy`
    returns (or the same fields read off the JAX package's cache)."""
    c = SplayVocabCache(**{f: d[f] for f in _CACHE_CONFIG},
                        refresh_on_device=refresh_on_device, device=device)
    dev = c._dev
    c.counts = np.array(d["counts"], np.int64)
    c.m, c.steps = int(d["m"]), int(d["steps"])
    c.hot_ids = np.array(d["hot_ids"], np.int32)
    c.hot_rank = torch.as_tensor(np.array(d["hot_rank"], np.int32),
                                 device=dev)
    if d["hot_ids_dev"] is not None:
        c._hot_ids_dev = torch.as_tensor(
            np.array(d["hot_ids_dev"], np.int32), device=dev)
    c.rng.bit_generator.state = d["rng_state"]
    if d["stream_state"] is not None:
        c._stream_st = state_from_numpy(d["stream_state"], device=dev)
        c._stream_plane = plane_from_numpy(d["stream_plane"], device=dev)
    c.stream_epochs = int(d["stream_epochs"])
    return c

"""State carried across the two packages as numpy arrays, so that both
start a test from the same state.

``state_from_numpy`` takes the dict that ``repro.core.splaylist.
to_numpy`` (or this package's ``splaylist.to_numpy``) returns;
``plane_from_numpy`` takes the ``DeviceLevelArrays`` fields as numpy
arrays — a mapping, or any NamedTuple of them.  The inverses return the
same forms.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import device_index as dix
from repro_torch.core import splaylist as sx


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

"""Shared helpers of the port's benchmark modules: the sequential
engines' timed loop, the engine factory and the CSV line."""

from __future__ import annotations

import time
from typing import Dict

from repro_torch.core import workload as wl
from repro_torch.core.cbtree import CBTree
from repro_torch.core.ref_py import SplayList
from repro_torch.core.skiplist import SkipList


def run_python_engine(engine, stream: wl.OpStream, measure_ops: int
                      ) -> Dict[str, float]:
    """Populate, then time ``measure_ops`` ops of the stream on the
    host.  Returns ops/sec and the average path length."""
    for k in stream.populate:
        engine.insert(int(k))
    kinds, keys, upd = stream.kinds, stream.keys, stream.upd
    t0 = time.perf_counter()
    plen = 0
    for i in range(measure_ops):
        kind = kinds[i]
        k = int(keys[i])
        if kind == wl.OP_CONTAINS:
            if isinstance(engine, SkipList):
                engine.find(k)
            else:
                engine.contains(k, upd=bool(upd[i]))
        elif kind == wl.OP_INSERT:
            engine.insert(k)
        else:
            engine.delete(k)
        plen += engine.last_path_len
    dt = time.perf_counter() - t0
    return {"ops_per_sec": measure_ops / dt,
            "avg_path": plen / measure_ops}


def make_engine(name: str, p: float, max_level: int = 24):
    if name == "skiplist":
        return SkipList(max_level=max_level)
    if name == "splaylist":
        return SplayList(max_level=max_level, p=p)
    if name == "cbtree":
        return CBTree(p=p)
    raise ValueError(name)


def emit(name: str, us_per_call: float, derived: str):
    print(f"{name},{us_per_call:.3f},{derived}")

"""Latency calibration on the card (``csrc/pointer_chase.cu``).

:func:`chase_ns` times one thread following ``i = next[i]`` through a
random cycle of ``n`` int32 slots: the ns per dependent load of an
array that fits the L2 or one that does not.  It is the yardstick for
kernel F's ns per walk step, whose loads also depend one on the next.
Not a kernel of any path, so it has no plain version and no launch
count; it needs a CUDA device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def chase_ns(n: int, steps: int, seed: int = 4,
             device: str = "cuda") -> float:
    """ns per dependent load over ``steps`` loads of a random cycle of
    ``n`` slots, read once before the timed chase.  After an untimed
    chase (the first launch also loads the module), two chases of
    ``steps // 10`` and ``steps`` loads, timed by CUDA events; their
    difference over ``0.9 * steps`` drops the launch."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the pointer chase runs only on a CUDA device")
    lib = build.load("pointer_chase")
    lib.pointer_chase.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p]
    lib.pointer_chase.restype = ctypes.c_int
    gen = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(n, generator=gen, device=dev)
    nxt = torch.empty((n,), dtype=torch.int32, device=dev)
    nxt[perm] = torch.roll(perm, -1).to(torch.int32)
    del perm
    out = torch.empty((1,), dtype=torch.int32, device=dev)
    nxt.sum()
    ms = []
    for n_steps in (steps // 10, steps // 10, steps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        code = lib.pointer_chase(nxt.data_ptr(), 0, n_steps,
                                 out.data_ptr(), build.stream_of(nxt))
        e1.record()
        build.check(lib, code, "pointer_chase launch")
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    return 1e6 * (ms[2] - ms[1]) / (steps - steps // 10)

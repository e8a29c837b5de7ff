"""The port's SPMD launcher: run one function on ``S`` ranks, one process
each, joined by ``torch.distributed``, as the reference runs one
``shard_map`` body over a mesh of ``S`` devices.

    results = spawn(fn, 4, backend="gloo")

Each rank is a fresh process (the ``spawn`` start method) on this host.
It joins a process group through a TCP store that the launching process
serves on the loopback address, on a port the system picks, so
concurrent launches never collide and no file is involved; gloo's own
sockets are bound to the loopback interface too (``GLOO_SOCKET_IFNAME``,
unless the caller set it).  The rank builds the world
:class:`~repro_torch.parallel.sharding.Mesh` on its device and calls
``fn(mesh, *args)``; ``spawn`` returns the ranks' results in rank
order.  A rank that crashes prints its threads' Python stacks to
standard error (``faulthandler``), and the launch's error names the
signal that ended it.

Devices: ``"cuda"``, the default, with gloo puts every rank on
``cuda:0`` (several ranks on one card: NCCL refuses two ranks on one
device); ``"cuda"`` with NCCL gives rank r ``cuda:r``, one rank per
card; ``"cpu"``, when the caller asks for it, puts every rank on the
CPU.  The backend is the caller's choice and nothing falls back: a rank
that finds no card, or any rank that raises, fails the launch, and
every process it started is stopped.
"""

from __future__ import annotations

import os
import queue
import signal
import time
import traceback

_HOST = "127.0.0.1"


def _rank_device(backend: str, device: str, rank: int):
    import torch
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: no CUDA device is available")
    index = rank if backend == "nccl" else 0
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"rank {rank}: no cuda:{index} "
                           f"({torch.cuda.device_count()} cards)")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _exit_reason(code) -> str:
    if code is None:
        return "still running"
    if code < 0:
        try:
            return f"killed by {signal.Signals(-code).name}"
        except ValueError:
            return f"killed by signal {-code}"
    return f"exit code {code}"


def _rank_main(rank, n, port, backend, device, threads, fn, args, out):
    try:
        import faulthandler
        faulthandler.enable()
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        import torch
        import torch.distributed as dist

        from repro_torch.parallel import sharding as shd
        if threads:
            torch.set_num_threads(threads)
        dev = _rank_device(backend, device, rank)
        store = dist.TCPStore(_HOST, port, n, False)
        dist.init_process_group(backend, store=store, world_size=n,
                                rank=rank)
        mesh = shd.world_mesh(dev)
        result = fn(mesh, *args)
        out.put((rank, True, result))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(fn, n_ranks: int, *args, backend: str = "gloo",
          device: str = "cuda", threads: int = None,
          timeout: float = 3600.0) -> list:
    """``fn(mesh, *args)`` on ``n_ranks`` processes; returns their
    results in rank order (each must pickle).  ``fn`` must be importable
    by its module path.  ``threads`` sets each rank's
    ``torch.set_num_threads``.  Raises ``RuntimeError`` with the first
    failing rank's traceback, or when ``timeout`` seconds pass."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                         f"{backend!r}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    ctx = mp.get_context("spawn")
    store = dist.TCPStore(_HOST, 0, None, True, wait_for_workers=False)
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_ranks, store.port, backend, device,
                               threads, fn, args, out))
             for r in range(n_ranks)]
    results = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(results) < n_ranks:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} ended before its result: "
                        f"{_exit_reason(procs[dead[0]].exitcode)}")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"ranks still running after "
                                       f"{timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        bad = [f"rank {r}: {_exit_reason(p.exitcode)}"
               for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError("ranks that returned their results then "
                               "failed to exit cleanly: " + "; ".join(bad))
        return [results[r] for r in range(n_ranks)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
        del store

"""The width-sharded cases of the port's mesh parity tests, written once
for both packages.

Each suite takes a package adapter ``P`` (:class:`JaxPkg`: the JAX
package on a ``jax.sharding.Mesh`` of host devices; :class:`TorchPkg`:
the port on one rank of a gloo world of CPU processes) and that
package's mesh of ``S`` shards, feeds both the same inputs made from
seeds with numpy, and returns ``{case: {name: numpy array or plain
value}}``.  Planes come back whole (the port's gathered).  The test
files run the JAX side in one subprocess (``python tests/mesh_cases.py
SUITE OUT``, with ``--xla_force_host_platform_device_count=4`` set
before JAX starts) and the port in gloo worlds of 1, 2 and 4 ranks
(``launch.spmd.spawn``), then compare case by case.

Only numpy is imported here at the top: the port's ranks import this
module and must not load JAX.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np

PAD = 2 ** 31 - 1
NEG_INF = -(2 ** 31) + 1
PLANE_FIELDS = ("keys", "widths", "heights", "rank_map", "slots",
                "bot_rank", "local_bot", "local_heights", "local_live",
                "local_ok")
SHARDS = (1, 2, 4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the two packages behind one face
# ---------------------------------------------------------------------------

class JaxPkg:
    name = "jax"

    def __init__(self):
        import jax
        import jax.numpy as jnp

        from repro.core import device_index as dix
        from repro.core import faults as fl
        from repro.core import plane_check as pc
        from repro.core import route_controller as rc
        from repro.core import splaylist as sx
        from repro.core import workload as wl
        from repro.kernels import splay_search as ssk
        from repro.parallel import sharding as shd
        from repro.serve import snapshot as snap
        from repro.serve.kv_cache import PagedKVPool
        from repro.train.checkpoint import CheckpointManager
        self.jax, self.jnp = jax, jnp
        self.dix, self.fl, self.pc, self.rc, self.sx = dix, fl, pc, rc, sx
        self.wl, self.ssk, self.shd, self.snap = wl, ssk, shd, snap
        self.Pool, self.Manager = PagedKVPool, CheckpointManager

    def mesh(self, S):
        return self.jax.sharding.Mesh(
            np.array(self.jax.devices()[:S]).reshape(1, S),
            ("data", "model"))

    def arr(self, x):
        return self.jnp.asarray(np.asarray(x))

    def np(self, x):
        return np.asarray(x)

    def plane_np(self, plane):
        return {f: np.asarray(getattr(plane, f)) for f in PLANE_FIELDS}

    def state_np(self, st):
        return self.sx.to_numpy(st)

    def pool(self, mesh=None, **kw):
        return self.Pool(mesh=mesh, **kw)

    def restore(self, mgr, mesh):
        return self.snap.restore_serving_snapshot(mgr, mesh=mesh)


class TorchPkg:
    name = "torch"

    def __init__(self):
        import torch

        from repro_torch.core import device_index as dix
        from repro_torch.core import faults as fl
        from repro_torch.core import plane_check as pc
        from repro_torch.core import route_controller as rc
        from repro_torch.core import splaylist as sx
        from repro_torch.core import workload as wl
        from repro_torch.kernels import splay_search as ssk
        from repro_torch.parallel import sharding as shd
        from repro_torch.serve import snapshot as snap
        from repro_torch.serve.kv_cache import PagedKVPool
        from repro_torch.train import elastic
        from repro_torch.train.checkpoint import CheckpointManager
        self.torch = torch
        self.dix, self.fl, self.pc, self.rc, self.sx = dix, fl, pc, rc, sx
        self.wl, self.ssk, self.shd, self.snap = wl, ssk, shd, snap
        self.elastic = elastic
        self.Pool, self.Manager = PagedKVPool, CheckpointManager
        self.world = None

    def mesh(self, S):
        assert self.world.size == S
        return self.world

    def arr(self, x):
        return self.torch.as_tensor(np.asarray(x))

    def np(self, x):
        return x.cpu().numpy() if self.torch.is_tensor(x) else np.asarray(x)

    def plane_np(self, plane):
        g = self.shd.gather_index_plane(plane)
        return {f: getattr(g, f).cpu().numpy() for f in PLANE_FIELDS}

    def state_np(self, st):
        return self.sx.to_numpy(st)

    def pool(self, mesh=None, **kw):
        return self.Pool(mesh=mesh, torch_device="cpu", **kw)

    def restore(self, mgr, mesh):
        return self.snap.restore_serving_snapshot(mgr, mesh=mesh,
                                                  device="cpu")


# ---------------------------------------------------------------------------
# inputs, from seeds (numpy only)
# ---------------------------------------------------------------------------

def skewed_fixture(n: int, W: int, L: int, seed: int):
    """``n`` sorted keys padded to ``W`` and their heights, the tall keys
    in the low key range: upper rows then live almost wholly in shard
    0's range, so the later shards' queries carry rank windows that
    straddle block boundaries."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(np.arange(0, 4 * n), n, replace=False))
    keys = np.concatenate([keys, np.full(W - n, PAD)]).astype(np.int32)
    hts = np.zeros(W, np.int32)
    tall = np.minimum(rng.geometric(0.35, n) - 1, L - 1)
    hts[:n] = np.where(np.arange(n) < n // 3, tall, tall // 3)
    return keys, hts


def boundary_queries(bot: np.ndarray, S: int, extra) -> np.ndarray:
    """Every block-first bottom-row key twice, its neighbours at +-1,
    below the smallest and above the largest live key, the int32
    extremes, then ``extra``."""
    wl = bot.shape[0] // S
    qs = []
    for s in range(S):
        first = int(bot[s * wl])
        qs += [first, first, max(first - 1, -PAD), min(first + 1, PAD)]
    live = bot[bot != PAD]
    if live.size:
        qs += [int(live[0]) - 7, int(live[-1]) + 7]
    qs += [-2 ** 31, -PAD, PAD - 1, PAD]
    return np.asarray(qs + list(extra), np.int64).astype(np.int32)


def make_state(P, pool, cap: int, L: int):
    st = P.sx.make(cap, max_level=L) if P.name == "jax" else \
        P.sx.make(cap, max_level=L, device="cpu")
    pool = np.asarray(pool, np.int32)
    st, _, _ = P.sx.run_ops(st, np.full(pool.size, P.sx.OP_INSERT, np.int32),
                            pool, np.ones(pool.size, bool))
    return st


def _triple(P, out, prefix=""):
    d = {prefix + "found": P.np(out[0]), prefix + "rank": P.np(out[1]),
         prefix + "level": P.np(out[2])}
    if len(out) > 3:
        st = out[3]
        d.update({prefix + "spill": P.np(st.spill),
                  prefix + "occupancy": P.np(st.occupancy),
                  prefix + "assembled": P.np(st.assembled)})
    return d


def _ordered(P, plane, mesh, qs, hits, sharded=True):
    ssk = P.ssk
    qs = P.arr(qs)
    lo, hi = qs, P.arr(np.asarray(P.np(qs), np.int64).clip(
        -2 ** 31, 2 ** 31 - 1 - 40).astype(np.int32) + 40)
    sel = P.arr(np.arange(-3, 200, 7, dtype=np.int32))
    out = {"select": P.np(ssk.splay_select(plane, sel, mesh=mesh)),
           "rank": P.np(ssk.splay_rank(plane, qs, sharded=sharded)),
           "range_count": P.np(ssk.splay_range_count(plane, lo, hi,
                                                     sharded=sharded))}
    for name, fn in (("pred", ssk.splay_predecessor),
                     ("succ", ssk.splay_successor)):
        k, r = fn(plane, qs, sharded=sharded)
        out[name + "_key"], out[name + "_rank"] = P.np(k), P.np(r)
    keys, cnt, tr = ssk.splay_range_scan(plane, lo, hi, 6, sharded=sharded)
    out.update(scan_keys=P.np(keys), scan_count=P.np(cnt),
               scan_trunc=P.np(tr))
    for k in (1, 17, 64):
        kk, hv, rk = ssk.splay_top_k(plane, P.arr(hits), k, mesh=mesh)
        out.update({f"top{k}_keys": P.np(kk), f"top{k}_hits": P.np(hv),
                    f"top{k}_ranks": P.np(rk)})
    return out


# ---------------------------------------------------------------------------
# the search suite
# ---------------------------------------------------------------------------

SEARCH_CASES = ("routed", "masked", "spill", "pipelined", "auto",
                "gather", "one_owner", "empty_rows", "all_empty",
                "no_queries", "indivisible", "mass_routed",
                "mass_masked", "ordered_lanes", "ordered_mass")


def search_suite(P, S: int) -> dict:
    mesh = P.mesh(S)
    ssk, dix, shd = P.ssk, P.dix, P.shd
    out = {}
    L, W = 10, 256
    keys, hts = skewed_fixture(180, W, L, seed=5)
    plane = dix.build_device(P.arr(keys), P.arr(hts), L)
    ps = shd.shard_index_plane(plane, mesh)
    rng = np.random.default_rng(100 + S)
    qs = boundary_queries(keys, S, rng.integers(-20, 760, 77))
    run = lambda pl, q, **kw: ssk.splay_search_sharded(  # noqa: E731
        pl, P.arr(q), mesh=mesh, return_stats=True, **kw)
    out["routed"] = _triple(P, run(ps, qs))
    out["masked"] = _triple(P, run(ps, qs, routed=False))
    out["spill"] = _triple(P, run(ps, qs, capacity=3))
    # the port's B2 on every shard; the JAX side's interpret-mode
    # pipelined kernel is slow, and its answers are by contract the
    # tiered ones, which the port's B2 must then equal
    out["pipelined"] = (out["routed"] if P.name == "jax" else
                        _triple(P, run(ps, qs, pipelined=True)))
    out["auto"] = _triple(P, ssk.splay_search(ps, P.arr(qs)))
    out["gather"] = _triple(P, ssk.splay_search(ps, P.arr(qs),
                                                sharded=False))
    live = keys[keys != PAD]
    one = rng.integers(int(live[-1]) - 40, int(live[-1]) + 40, 64)
    out["one_owner"] = _triple(P, run(ps, one.astype(np.int32)))
    flat = dix.build_device(P.arr(keys), P.arr(np.zeros(W, np.int32)), L)
    out["empty_rows"] = _triple(P, run(shd.shard_index_plane(flat, mesh),
                                       qs))
    empty = dix.build_device(P.arr(np.full(W, PAD, np.int32)),
                             P.arr(np.zeros(W, np.int32)), L)
    out["all_empty"] = _triple(P, run(shd.shard_index_plane(empty, mesh),
                                      qs))
    out["no_queries"] = _triple(P, run(ps, np.zeros(0, np.int32)))
    k3, h3 = skewed_fixture(150, 251, L, seed=6)
    odd = shd.shard_index_plane(
        dix.build_device(P.arr(k3), P.arr(h3), L), mesh)
    out["indivisible"] = _triple(P, run(odd, qs))

    # a state-built plane (a live slot map) under both splits
    cap = 258
    pool = np.random.default_rng(7).choice(900, 200, replace=False)
    st = make_state(P, pool, cap, L)
    base = dix.from_state_device(st, n_levels=L, width=W)
    lanes = shd.shard_index_plane(base, mesh)
    churn = np.random.default_rng(8)
    st2, _, _ = P.sx.run_ops(
        st, churn.choice([0, 0, 1, 2], 48).astype(np.int32),
        churn.integers(0, 950, 48).astype(np.int32), np.ones(48, bool))
    mass, _ = dix.refresh_device_sharded(st2, lanes, max_new=48, mesh=mesh,
                                         split="mass")
    q2 = boundary_queries(P.plane_np(mass)["keys"][-1], S,
                          churn.integers(-5, 960, 61))
    out["mass_routed"] = _triple(P, run(mass, q2))
    out["mass_masked"] = _triple(P, run(mass, q2, routed=False))
    hits = P.np(st2.selfhits).astype(np.int32)
    hits0 = P.np(st.selfhits).astype(np.int32)
    out["ordered_lanes"] = _ordered(P, lanes, mesh, q2, hits0)
    out["ordered_mass"] = _ordered(P, mass, mesh, q2, hits)
    return out


# ---------------------------------------------------------------------------
# the refresh suite
# ---------------------------------------------------------------------------

REFRESH_EPOCHS = 4
REFRESH_CASES = tuple(
    [f"lanes_e{e}" for e in range(REFRESH_EPOCHS)]
    + [f"mass_e{e}" for e in range(REFRESH_EPOCHS)]
    + ["overflow", "stale", "emptied", "refill", "indivisible",
       "audit_lanes", "audit_mass", "audit_flipped", "to_host"])


def _refreshed(P, plane, ovf, st=None):
    d = dict(P.plane_np(plane))
    d["overflow"] = P.np(ovf)
    d["segmented"] = bool(P.dix.plane_is_segmented(plane))
    if st is not None:
        d["n_segments"] = int(P.pc.infer_segments(plane))
    return d


def refresh_suite(P, S: int) -> dict:
    mesh = P.mesh(S)
    dix, shd, sx = P.dix, P.shd, P.sx
    out = {}
    L, W, cap = 10, 256, 420
    rng = np.random.default_rng(20 + S)
    st = make_state(P, rng.choice(1200, 180, replace=False), cap, L)
    lanes = mass = shd.shard_index_plane(
        dix.from_state_device(st, n_levels=L, width=W), mesh)
    for e in range(REFRESH_EPOCHS):
        kinds = rng.choice([0, 1, 1, 2], 40).astype(np.int32)
        ks = rng.integers(0, 1300, 40).astype(np.int32)
        if e == 2:      # a hot set: skewed hit counters for the mass split
            kinds[:] = 0
            ks = rng.choice(np.asarray(P.state_np(st)["key"])[2:60], 40)
        st, _, _ = sx.run_ops(st, kinds, ks.astype(np.int32),
                              np.ones(40, bool))
        lanes, ov = dix.refresh_device_sharded(st, lanes, max_new=40,
                                               mesh=mesh)
        out[f"lanes_e{e}"] = _refreshed(P, lanes, ov, st)
        mass, ov = dix.refresh_device_sharded(st, mass, max_new=40,
                                              mesh=mesh, split="mass")
        out[f"mass_e{e}"] = _refreshed(P, mass, ov, st)
    # an insert burst past max_new and past the width
    burst = np.arange(2000, 2000 + 90, dtype=np.int32)
    st_b, _, _ = sx.run_ops(st, np.full(90, sx.OP_INSERT, np.int32), burst,
                            np.ones(90, bool))
    pl, ov = dix.refresh_device_sharded(st_b, lanes, max_new=8, mesh=mesh)
    out["overflow"] = _refreshed(P, pl, ov)
    # a rebuilt (slot-compacted) state: the stale slot-map branch
    st_r = sx.rebuild(st)
    pl, ov = dix.refresh_device_sharded(st_r, mass, max_new=40, mesh=mesh)
    out["stale"] = _refreshed(P, pl, ov)
    # delete every key, then insert some back
    live = P.state_np(st)["key"]
    live = live[(live > NEG_INF) & (live < PAD)]
    st_e, _, _ = sx.run_ops(st, np.full(live.size, sx.OP_DELETE, np.int32),
                            live.astype(np.int32), np.ones(live.size, bool))
    st_e = sx.rebuild(st_e)
    pe, ov = dix.refresh_device_sharded(st_e, lanes, max_new=40, mesh=mesh)
    out["emptied"] = _refreshed(P, pe, ov)
    back = rng.choice(1300, 30, replace=False).astype(np.int32)
    st_f, _, _ = sx.run_ops(st_e, np.full(30, sx.OP_INSERT, np.int32),
                            back, np.ones(30, bool))
    pf, ov = dix.refresh_device_sharded(st_f, pe, max_new=40, mesh=mesh,
                                        split="mass")
    out["refill"] = _refreshed(P, pf, ov)
    # an indivisible width takes the replicated refresh
    odd = shd.shard_index_plane(
        dix.from_state_device(st, n_levels=L, width=254 if S == 4 else 255),
        mesh)
    pl, ov = dix.refresh_device_sharded(st_b, odd, max_new=40, mesh=mesh)
    out["indivisible"] = _refreshed(P, pl, ov)
    out["audit_lanes"] = {"audit": list(P.pc.audit_plane(st, lanes))}
    out["audit_mass"] = {"audit": list(P.pc.audit_plane(st, mass)),
                         "n_segments": int(P.pc.infer_segments(mass))}
    n_seg = int(P.pc.infer_segments(mass))
    flipped, recs = P.fl.flip_plane_bits(mass, np.random.default_rng(S), 6)
    out["audit_flipped"] = {
        "audit": list(P.pc.audit_plane(st, flipped, n_segments=n_seg)),
        "records": [(f, tuple(int(i) for i in ix), int(b))
                    for f, ix, b in recs]}
    host = dix.to_host(lanes)
    out["to_host"] = {f: np.asarray(getattr(host, f))
                      for f in ("keys", "widths", "heights", "rank_map")}
    return out


# ---------------------------------------------------------------------------
# the serving suite
# ---------------------------------------------------------------------------

SERVING_CASES = ("serve_lanes", "serve_mass", "serve_masked",
                 "serve_spill", "serve_mixed", "serve_ordered",
                 "controller", "pool_request", "pool_scan", "pool_loss",
                 "snapshot")
# cases whose answers differ by rank (ranks outside the survivors serve
# meshless after a shard loss): compared on the survivors only
SURVIVOR_CASES = ("pool_loss", "snapshot")
# a shard loss to 2 needs at least 2 shards (the JAX pool takes the
# host's first 2 devices, which one rank does not have)
SERVING_SHARDS = {"pool_loss": (2, 4), "snapshot": (2, 4)}


def _served(P, out, with_plane=True):
    st, plane, res, plen, ovf, spl, occ = out[:7]
    d = {"res": P.np(res), "plen": P.np(plen), "ovf": P.np(ovf),
         "spill": P.np(spl), "occ": P.np(occ)}
    d.update({"st_" + k: v for k, v in P.state_np(st).items()})
    if with_plane:
        d.update({"pl_" + k: v for k, v in P.plane_np(plane).items()})
    return d


def _replay(P, pool, trace, max_range=4):
    wl = P.wl
    log = []
    his = trace.hi_ids if trace.hi_ids is not None else trace.seq_ids
    for k, s, hi in zip(trace.kinds.tolist(), trace.seq_ids.tolist(),
                        his.tolist()):
        if k == wl.KV_CREATE:
            ok = pool.create(s)
            if ok:
                ok = pool.append_tokens(s, 3) and ok
            log.append((k, s, bool(ok)))
        elif k == wl.KV_LOOKUP:
            c = pool.lookup(s)
            log.append((k, s, None if c is None else tuple(c)))
        elif k == wl.KV_RELEASE:
            pool.release(s)
            log.append((k, s, round(pool.utilization, 6)))
        elif k == wl.KV_SCAN:
            ids, cnt, tr = pool.lookup_range(s, hi, max_range=max_range)
            log.append((k, s, (tuple(int(x) for x in ids), int(cnt),
                               int(tr))))
        else:
            log.append((k, s, pool.predecessor(s)))
    return log


def _pool_result(pool, log):
    return {"log": log, "chains": sorted(pool.chains),
            "free": list(pool.free), "stats": dict(pool.stats),
            "ctrl": tuple(pool.ctrl), "spill_traj": list(pool.spill_traj)}


def serving_suite(P, S: int, tmp: str) -> dict:
    mesh = P.mesh(S)
    sx, dix = P.sx, P.dix
    out = {}
    L, W, cap, E, B = 10, 256, 258, 4, 64
    rng = np.random.default_rng(40 + S)
    pool_keys = rng.choice(1000, 200, replace=False).astype(np.int32)
    st = make_state(P, pool_keys, cap, L)
    plane = dix.from_state_device(st, n_levels=L, width=W)
    hot = pool_keys[:12]
    keys = np.where(rng.random((E, B)) < 0.7, rng.choice(hot, (E, B)),
                    rng.integers(-10, 1100, (E, B))).astype(np.int32)
    ups = rng.random((E, B)) < 0.6
    kinds = np.zeros((E, B), np.int32)
    kw = dict(aggregate=True, plane_search=True, mesh=mesh)
    out["serve_lanes"] = _served(P, sx.run_serving(st, plane, kinds, keys,
                                                   ups, **kw))
    out["serve_mass"] = _served(P, sx.run_serving(
        st, plane, kinds, keys, ups, split="mass", **kw))
    out["serve_masked"] = _served(P, sx.run_serving(
        st, plane, kinds, keys, ups, routed=False, **kw))
    out["serve_spill"] = _served(P, sx.run_serving(
        st, plane, kinds, keys, ups, route_capacity=2, **kw))
    mixed = rng.choice([0, 0, 1, 2], (E, B)).astype(np.int32)
    out["serve_mixed"] = _served(P, sx.run_serving(
        st, plane, mixed, keys, ups, max_new=6, mesh=mesh, split="mass"))
    okinds = rng.choice([sx.OP_CONTAINS, sx.OP_PRED, sx.OP_RANGE],
                        (E, B)).astype(np.int32)
    out["serve_ordered"] = _served(P, sx.run_serving(
        st, plane, okinds, keys, ups, ordered=True, **kw))
    # the controller: a one-owner hot set spills and escalates to mass
    hot_keys = np.sort(pool_keys)[-8:]
    ck = rng.choice(hot_keys, (5, B)).astype(np.int32)
    cout = P.rc.run_serving_controlled(
        st, plane, np.zeros((5, B), np.int32), ck, np.ones((5, B), bool),
        **kw)
    d = _served(P, cout, with_plane=False)
    d["states"] = [tuple(s) for s in cout[7]]
    out["controller"] = d
    return out


def serving_pool_suite(P, S: int, tmp: str) -> dict:
    """The pool cases of the serving suite (a part of its own, so that
    the JAX side can run it in a second process)."""
    mesh = P.mesh(S)
    out = {}
    wl, fl = P.wl, P.fl
    pkw = dict(n_pages=48, page_size=4, device=True, index_width=32,
               index_batch=8)
    for name, trace in (("pool_request", wl.kv_request_trace(64, 14,
                                                             seed=S)),
                        ("pool_scan", wl.kv_scan_trace(64, 14,
                                                       seed=S + 7))):
        pool = P.pool(mesh=mesh, audit_every=3, **pkw)
        out[name] = _pool_result(pool, _replay(P, pool, trace))
    if S < 2:
        return out
    trace = wl.kv_scan_trace(160, 14, seed=11)
    plan = fl.FaultPlan(seed=3, events=[
        fl.FaultEvent(4, fl.FAULT_TELEMETRY, 2),
        fl.FaultEvent(9, fl.FAULT_SHARD_LOSS, 2)])
    pool = P.pool(mesh=mesh, audit_every=2, fault_plan=plan, **pkw)
    out["pool_loss"] = _pool_result(pool, _replay(P, pool, trace))
    # a snapshot mid-trace, restored onto 2 ranks
    trace = wl.kv_request_trace(140, 14, seed=12)
    n0 = 80
    first = type(trace)(**{f: (v[:n0] if isinstance(v, np.ndarray) else v)
                           for f, v in trace._asdict().items()})
    rest = type(trace)(**{f: (v[n0:] if isinstance(v, np.ndarray) else v)
                          for f, v in trace._asdict().items()})
    pool = P.pool(mesh=mesh, audit_every=0, **pkw)
    log = _replay(P, pool, first)
    mgr = P.Manager(tmp)
    P.snap.save_serving_snapshot(mgr, 5, pool)
    mesh2 = (P.mesh(2) if P.name == "jax" else
             P.elastic.remesh([0, 1], model_parallel=2, device="cpu"))
    back, _, summary = P.restore(mgr, mesh2)
    res = _pool_result(back, log + _replay(P, back, rest))
    res["summary"] = summary
    out["snapshot"] = res
    return out


SUITES = {"search": (search_suite, SEARCH_CASES),
          "refresh": (refresh_suite, REFRESH_CASES),
          "serving": (serving_suite, SERVING_CASES)}
# suites the JAX side splits into parts, each part a process per S
PARTS = {"serving": {"serve": serving_suite, "pool": serving_pool_suite}}


def cases_of(suite: str):
    """The ``(S, case)`` pairs a suite's test file parametrises over."""
    names = SUITES[suite][1]
    shards = SERVING_SHARDS if suite == "serving" else {}
    return [(S, c) for S in SHARDS for c in names
            if S in shards.get(c, SHARDS)]


def _run_suite(P, suite, S, tmp, part=None):
    if suite in PARTS:
        fns = ([PARTS[suite][part]] if part else PARTS[suite].values())
        out = {}
        for fn in fns:
            out.update(fn(P, S, tmp))
        return out
    return SUITES[suite][0](P, S)


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------

def torch_rank(mesh, suite: str, tmp: str) -> dict:
    """One rank of the port's gloo world: the suite at ``S = mesh.size``
    (the body ``launch.spmd.spawn`` runs)."""
    P = TorchPkg()
    P.world = mesh
    return _run_suite(P, suite, mesh.size, tmp)


def remesh_rank(mesh) -> dict:
    """``train.elastic.remesh`` on a rank of a 4-rank world: rows of 2
    (a 2 x 2 grid), the first 3 survivors at model parallel 2 (one row
    of ranks 0 and 1), and a refusal when 3 cannot host 4."""
    from repro_torch.parallel import collectives as cl
    from repro_torch.train import elastic
    import torch
    out = {}
    grid = elastic.remesh(model_parallel=2, device="cpu")
    x = torch.tensor([mesh.index], dtype=torch.int32)
    out["grid"] = (dict(grid.shape), grid.ranks, grid.index,
                   cl.psum(x, grid).tolist())
    three = elastic.remesh([0, 1, 2], model_parallel=2, device="cpu")
    out["three"] = None if three is None else (dict(three.shape),
                                               three.ranks)
    try:
        elastic.remesh([0, 1, 2], model_parallel=4, device="cpu")
    except RuntimeError as e:
        out["refused"] = str(e)
    return out


def row_snapshot_rank(mesh, tmp: str) -> dict:
    """Serving snapshots of pools on the rows of a 2 x 2
    ``elastic.remesh`` grid, on a rank of a 4-rank world: each row
    replays its own trace on its pool, snapshots it into its own
    directory and restores it onto the same row; then rank 3 alone
    snapshots and restores a meshless pool, which no other rank joins."""
    import os
    P = TorchPkg()
    grid = P.elastic.remesh(model_parallel=2, device="cpu")
    row = grid.ranks[0] // 2
    pool = P.pool(mesh=grid, n_pages=48, page_size=4, device=True,
                  index_width=32, index_batch=8, audit_every=0)
    log = _replay(P, pool, P.wl.kv_request_trace(60, 14, seed=30 + row))
    mgr = P.Manager(os.path.join(tmp, f"row{row}"))
    P.snap.save_serving_snapshot(mgr, 1, pool)
    back, _, _ = P.restore(mgr, grid)
    out = {"row": row, "log": log, "chains": pool.chains,
           "back": (back.chains, back.free == pool.free,
                    back.mesh is not None and back.mesh.ranks)}
    if mesh.index == 3:
        solo = P.pool(n_pages=48, page_size=4, device=True,
                      index_width=32, index_batch=8)
        _replay(P, solo, P.wl.kv_request_trace(40, 14, seed=50))
        mgr = P.Manager(os.path.join(tmp, "solo"))
        P.snap.save_serving_snapshot(mgr, 1, solo)
        again, _, _ = P.restore(mgr, None)
        out["solo"] = (again.chains == solo.chains, bool(solo.chains))
    return out


# ---------------------------------------------------------------------------
# the models on a mesh (tests/test_torch_model_mesh.py)
# ---------------------------------------------------------------------------

MODEL_ARCHS = ("minitron-8b", "qwen2-0.5b")
ENGINE_ARCH = "qwen2-0.5b"
ENGINE_ARGS = dict(max_batch=2, max_seq=48, n_pages=64, page_size=4,
                   use_splay_tier=True, stream_epochs=2, device_index=True,
                   index_batch=4)
ENGINE_CASES = {
    # one burst, a tight pool: stalls and preemptions
    "burst_tight_pool": (dict(n_requests=6, rate=float("inf"), vocab=64,
                              prompt_len=(3, 6), max_new=6, seed=4),
                         dict(n_pages=7, max_batch=3)),
    # Poisson arrivals: idle jumps, waves of one and two
    "poisson": (dict(n_requests=6, rate=0.4, vocab=512, prompt_len=(2, 5),
                     max_new=(2, 5), seed=9), {}),
}
DECODE_STEPS = 6


def model_inputs(cfg_vocab: int, seed: int = 0) -> np.ndarray:
    """The ``[2, DECODE_STEPS]`` ids the forward and the decode steps
    take."""
    return np.random.default_rng(seed).integers(
        0, cfg_vocab, (2, DECODE_STEPS)).astype(np.int32)


def engine_summary(eng, results) -> dict:
    """What an engine emits, in plain values (both packages)."""
    vc = eng.vocab_cache
    return dict(results=results, latencies=dict(eng.latencies),
                clock=eng.clock, stalls=eng.stalls,
                preemptions=eng.preemptions, retries=eng.degraded_retries,
                tokens_out=eng.tokens_out, chains=dict(eng.pool.chains),
                free=sorted(eng.pool.free), util=eng.pool.utilization,
                vc_m=vc.m, vc_counts=np.asarray(vc.counts).tolist(),
                vc_hot=np.asarray(vc.hot_ids).tolist())


def submit_arrivals(eng, arr, req) -> None:
    for i in range(len(arr.seq_ids)):
        n = int(arr.prompt_lens[i])
        eng.submit(req(seq_id=int(arr.seq_ids[i]),
                       prompt=arr.prompts[i, :n].copy(),
                       max_new=int(arr.max_new[i]),
                       arrival=int(arr.arrival[i])))


def _whole(x, spec, mesh):
    """A laid-out result gathered whole (a collective)."""
    from repro_torch.parallel import sharding as shd
    return shd.relayout(x, spec, (), mesh).numpy()


def model_mesh_rank(mesh, params_np: dict) -> dict:
    """The models on a mesh, on one rank of a gloo world of CPU ranks:
    for each of ``MODEL_ARCHS`` (smoke width, float32, the JAX
    parameters ``params_np[arch]``) laid out by ``axes_to_specs`` on the
    world's ``1 x S`` mesh, ``forward`` and ``DECODE_STEPS`` decode steps
    (logits gathered whole) and the greedy ids of ``prefill_loop``; the
    engine on the mesh with the global and the laid-out tree for each
    of ``ENGINE_CASES``."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.core import convert
    from repro_torch.core import workload as twl
    from repro_torch.models import layers as ly
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve import serve_step as ss
    from repro_torch.serve.engine import Engine, Request

    rules = shd.default_rules()
    out = {"specs": {}, "fwd": {}, "dec": {}, "greedy": {}, "engine": {},
           "cache_kv_heads": {}}
    trees = {}
    for arch in MODEL_ARCHS:
        cfg = registry.get_smoke(arch)
        params = convert.params_from_numpy(params_np[arch], device="cpu")
        _, axes = zoo.param_axes(cfg)
        specs = ly.axes_to_specs(params, axes, mesh, rules)
        tree = shd.lay_out(params, specs, mesh)
        trees[arch] = (params, tree)
        out["specs"][arch] = specs
        head = specs["embed"] if cfg.tie_embeddings else specs["unembed"]
        vocab = ly.split_over(head, 0 if cfg.tie_embeddings else 1)
        lspec = (None, None, vocab if vocab else None)
        toks = torch.as_tensor(model_inputs(cfg.vocab).astype(np.int64))
        out["fwd"][arch] = _whole(zoo.forward(tree, cfg, toks), lspec,
                                  mesh)
        cache = zoo.init_cache(cfg, 2, 16, "cpu", mesh=mesh)
        steps = []
        for t in range(DECODE_STEPS):
            logits, cache = zoo.decode_step(tree, cfg, toks[:, t:t + 1],
                                            cache, t)
            steps.append(_whole(logits, lspec, mesh))
        out["dec"][arch] = steps
        out["cache_kv_heads"][arch] = int(cache["k"].shape[3])
        last, _, _ = ss.prefill_loop(
            ss.make_decode_step(cfg), tree, toks.numpy(),
            zoo.init_cache(cfg, 2, 16, "cpu", mesh=mesh))
        out["greedy"][arch] = last[:, 0].tolist()
    cfg = registry.get_smoke(ENGINE_ARCH)
    params, tree = trees[ENGINE_ARCH]
    for case, (arr_kw, kw) in ENGINE_CASES.items():
        for kind, p in (("global", params), ("laid_out", tree)):
            eng = Engine(cfg, p, mesh=mesh, device="cpu",
                         **dict(ENGINE_ARGS, **kw))
            submit_arrivals(eng, twl.poisson_zipf_arrivals(**arr_kw),
                            Request)
            out["engine"][case, kind] = engine_summary(eng, eng.run())
    return out


# ---------------------------------------------------------------------------
# the other model families on a mesh (tests/test_torch_model_mesh_families.py)
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("phi3.5-moe-42b-a6.6b", "arctic-480b", "mamba2-1.3b",
                "zamba2-7b", "whisper-large-v3", "paligemma-3b")
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE6 = "phi3.5-moe-6"             # the smoke phi with 6 experts
DENSE_ARCH = "minitron-8b"
FAMILY_SHAPE = (2, 8)             # the forward's batch x sequence
FAMILY_STEPS = 3                  # decode steps from an empty cache
# the models of each world: 1 x S for S in (2, 4), and the 2 x 2 mesh of
# the 4 ranks
FAMILY_MODELS = {2: FAMILY_ARCHS, 4: FAMILY_ARCHS + (MOE6,),
                 "2x2": (DENSE_ARCH, MOE_ARCH)}
MOE_BLOCK_CASES = ("phi", "arctic", "drops", "experts6")


def family_cfg(registry, name: str):
    """The smoke config of ``name`` from either package's registry."""
    import dataclasses
    if name == MOE6:
        return dataclasses.replace(registry.get_smoke(MOE_ARCH),
                                   n_experts=6)
    return registry.get_smoke(name)


def family_inputs(cfg, seed: int = 0):
    """The forward's ids ``[2, 8]`` and the stub frontend (whisper's
    frames, paligemma's patches, at the embedding's scale) or ``None``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, FAMILY_SHAPE).astype(np.int32)
    n = {"encdec": cfg.enc_positions, "vlm": cfg.img_tokens}.get(
        cfg.family)
    fr = None if n is None else (0.02 * rng.standard_normal(
        (FAMILY_SHAPE[0], n, cfg.d_model))).astype(np.float32)
    return toks, fr


def moe_block_case(registry, case: str):
    """One MoE layer's weights at 1/sqrt(fan_in) and its input ``[2, 12,
    d]`` for ``case``: ``phi``, ``arctic`` (the dense residual),
    ``drops`` (the router sends every token to expert 0 first, so the
    capacity drops most of them) and ``experts6`` (6 experts, which 4
    ranks do not divide).  Returns ``(cfg name, weights, x)``."""
    name = {"phi": MOE_ARCH, "arctic": "arctic-480b", "drops": MOE_ARCH,
            "experts6": MOE6}[case]
    cfg = family_cfg(registry, name)
    d, ff, e, rf = cfg.d_model, cfg.d_ff, cfg.n_experts, \
        cfg.dense_residual_ff
    shapes = {"router": (d, e), "w_gate": (e, d, ff), "w_up": (e, d, ff),
              "w_down": (e, ff, d)}
    if rf:
        shapes.update(res_gate=(d, rf), res_up=(d, rf), res_down=(rf, d))
    rng = np.random.default_rng(3)
    p = {n: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
         for n, s in shapes.items()}
    x = rng.standard_normal((2, 12, d)).astype(np.float32)
    if case == "drops":
        u = np.full(d, 1 / np.sqrt(d), np.float32)
        x = (x + 3 * u).astype(np.float32)
        p["router"][:, 0] = 5 * u
    return name, p, x


def _rows(mesh, rules, n: int):
    """This rank's rows of a batch of ``n`` (its block over ``batch``)."""
    from repro_torch.parallel import sharding as shd
    spec = shd.resolve_spec((n,), ("batch",), mesh, rules)
    return shd.block_slices((n,), spec, mesh)[0], spec


def _family_model(mesh, cfg, params_np, stages, caches, rules) -> dict:
    """One model laid out on ``mesh``: the forward stage by stage (each
    stage from the JAX state ``stages``, read back as this rank's
    state), the untapped forward's logits, ``FAMILY_STEPS`` decode steps
    each from the JAX cache before it (``caches[t]``, cut to this
    rank's blocks) and the same steps from the rank's own cache, all
    gathered whole; the cache's block shapes."""
    import torch

    from repro_torch.core import convert
    from repro_torch.models import layers as ly
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as shd
    params = convert.params_from_numpy(params_np, device="cpu")
    _, axes = zoo.param_axes(cfg)
    specs = ly.axes_to_specs(params, axes, mesh, rules)
    tree = shd.lay_out(params, specs, mesh, rules)
    toks, fr = family_inputs(cfg)
    rows, bspec = _rows(mesh, rules, toks.shape[0])
    t = torch.as_tensor(toks[rows].astype(np.int64))
    f = None if fr is None else torch.as_tensor(fr[rows])
    lspec = (bspec[0] if bspec else None, None,
             zoo.vocab_axes(tree, cfg) or None)
    out = {"specs": specs, "stages": {}}

    def tap(name, x):
        out["stages"][name] = _whole(x, lspec[:1], mesh)
        return torch.as_tensor(stages[name][rows])
    out["tapped"] = _whole(zoo.forward(tree, cfg, t, frontend=f, tap=tap),
                           lspec, mesh)
    out["fwd"] = _whole(zoo.forward(tree, cfg, t, frontend=f), lspec, mesh)
    cache = zoo.init_cache(cfg, toks.shape[0], 16, "cpu", mesh=mesh,
                           rules=rules)
    out["cache_shapes"] = {k: tuple(v.shape) for k, v in cache.items()}
    cax = zoo.cache_axes(cfg)
    out["dec"], out["free"] = [], []
    for i in range(FAMILY_STEPS):
        ref = {k: shd.shard_tensor(v, shd.resolve_spec(
            v.shape, cax[k], mesh, rules), mesh)
            for k, v in caches[i].items()}
        logits, _ = zoo.decode_step(tree, cfg, t[:, i:i + 1], ref, i)
        out["dec"].append(_whole(logits, lspec, mesh))
        logits, cache = zoo.decode_step(tree, cfg, t[:, i:i + 1], cache, i)
        out["free"].append(_whole(logits, lspec, mesh).argmax(-1))
    return out


def _moe_block_on(mesh, registry, case, rules) -> dict:
    """:func:`moe_block_case` ``case`` laid out on ``mesh`` (the layer's
    axes without the layer axis): the block's output, this rank's
    routing (``top_e``, ``keep``) and its expert weights' spec."""
    import torch

    from repro_torch.models import layers as ly
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel import sharding as shd
    name, p, x = moe_block_case(registry, case)
    cfg = family_cfg(registry, name)
    _, axes = zoo.param_axes(cfg)
    w = {k: torch.as_tensor(v) for k, v in p.items()}
    specs = {k: shd.resolve_spec(v.shape, axes[k][1:], mesh, rules)
             for k, v in w.items()}
    lp = ly.Blocks({k: shd.shard_tensor(v, specs[k], mesh)
                    for k, v in w.items()}, specs)
    rows, _ = _rows(mesh, rules, x.shape[0])
    xt = torch.as_tensor(x[rows])
    with shd.use_mesh(mesh, rules):
        y = moe_mod.moe_block(xt, lp, cfg, torch.float32)
        plan = moe_mod.route(xt, lp, cfg, torch.float32)
    return {"y": y.numpy(), "top_e": plan.top_e.numpy(),
            "keep": plan.keep.numpy(), "rows": rows,
            "w_gate": specs["w_gate"]}


def family_mesh_rank(mesh, job) -> dict:
    """The other families on a mesh, on one rank of a gloo world of CPU
    ranks of ``S`` = 2 or 4: each model of ``FAMILY_MODELS[S]`` laid out
    on the ``1 x S`` mesh (:func:`_family_model`, from the JAX
    parameters ``job["params"]`` and stages ``job["stages"]``), the MoE
    block cases, and ``Engine(mesh=...)`` on the laid-out moe smoke tree
    for each of ``ENGINE_CASES``; with 4 ranks also the 2 x 2 (data,
    model) mesh's models and MoE blocks, batch rows over ``data`` and
    fsdp over it, and the engine's refusal of that mesh's tree."""
    from repro_torch.configs import registry
    from repro_torch.core import convert
    from repro_torch.core import workload as twl
    from repro_torch.models import layers as ly
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.train import elastic
    import torch
    torch.set_grad_enabled(False)
    rules = shd.default_rules()
    S = mesh.shape["model"]
    meshes = {S: mesh}
    if S == 4:
        meshes["2x2"] = elastic.remesh(model_parallel=2, device="cpu")
    out = {"models": {}, "moe": {}, "engine": {},
           "coords": {k: dict(m.coords) for k, m in meshes.items()}}
    for key, m in meshes.items():
        for name in FAMILY_MODELS[key]:
            cfg = family_cfg(registry, name)
            out["models"][key, name] = _family_model(
                m, cfg, job["params"][name], job["stages"][name],
                job["caches"][name], rules)
        for case in MOE_BLOCK_CASES:
            out["moe"][key, case] = _moe_block_on(m, registry, case, rules)
    cfg = family_cfg(registry, MOE_ARCH)
    params = convert.params_from_numpy(job["params"][MOE_ARCH], device="cpu")
    _, axes = zoo.param_axes(cfg)
    if "2x2" in meshes:                 # the batch over data: refused
        m = meshes["2x2"]
        try:
            Engine(cfg, shd.lay_out(params, ly.axes_to_specs(
                params, axes, m, rules), m, rules), mesh=m, device="cpu")
            out["engine_2x2"] = None
        except NotImplementedError as e:
            out["engine_2x2"] = str(e)
    tree = shd.lay_out(params, ly.axes_to_specs(params, axes, mesh, rules),
                       mesh, rules)
    for case, (arr_kw, kw) in ENGINE_CASES.items():
        eng = Engine(cfg, tree, mesh=mesh, device="cpu",
                     **dict(ENGINE_ARGS, **kw))
        submit_arrivals(eng, twl.poisson_zipf_arrivals(**arr_kw), Request)
        out["engine"][case] = engine_summary(eng, eng.run())
    return out


# ---------------------------------------------------------------------------
# the sequence layouts (tests/test_torch_seq_layouts.py)
# ---------------------------------------------------------------------------

DENSE6 = "minitron-8b-h6"         # the dense smoke with 6 heads, 2 kv heads
DENSE_Q8 = "minitron-8b-q8"       # the dense smoke with the int8 cache
SEQ_ARCHS = FAMILY_ARCHS + (DENSE_ARCH, DENSE6)
SEQ_STEPS = (1, 2, 3)             # decode steps: 2 starts a rank's block
SEQ_CACHE = {"kvseq": 8, "seq_data": 4}    # 2 positions a rank either way
# (layout, model, part): the dry-run's four rule sets, forward ("fwd")
# on 1 x 4 under cp_seq and cp_seq + cp_q, decode ("dec") on 1 x 4 with
# kvseq over model, and both on 2 x 2 with seq/kvseq over data (batch 1)
SEQ_CASES = ([("cp_seq", n, "fwd") for n in SEQ_ARCHS]
             + [("cp_q", n, "fwd") for n in SEQ_ARCHS]
             + [("kvseq", n, "dec") for n in SEQ_ARCHS + (DENSE_Q8,)]
             + [("seq_data", n, part) for n in SEQ_ARCHS
                for part in ("fwd", "dec")])
BLOCKWISE_CASES = ("causal", "prefix")


def seq_cfg(registry, name: str):
    """:func:`family_cfg`, and the two dense variants of the sequence
    layouts' cases."""
    import dataclasses
    if name == DENSE6:
        return dataclasses.replace(registry.get_smoke(DENSE_ARCH),
                                   n_heads=6, n_kv=2)
    if name == DENSE_Q8:
        return dataclasses.replace(registry.get_smoke(DENSE_ARCH),
                                   kv_cache_dtype="int8")
    return family_cfg(registry, name)


def seq_batch(layout: str) -> int:
    """The global batch of a layout's cases: 1 where ``seq`` takes
    ``data`` (the dry-run's ``seq_sharded`` rules), else 2."""
    return 1 if layout == "seq_data" else FAMILY_SHAPE[0]


def seq_rules(layout: str):
    """The rule table of a layout."""
    from repro_torch.parallel import sharding as shd
    if layout == "seq_data":
        return shd.default_rules(seq_sharded=True)
    rules = shd.default_rules()
    if layout in ("cp_seq", "cp_q"):
        rules["cp_seq"] = ("model",)
    if layout == "cp_q":
        rules["cp_q"] = ("model",)
    if layout == "kvseq":
        rules["kvseq"] = ("model",)
    return rules


def seq_slice(b: int, max_seq: int, stages=None, cache=None):
    """The references of a batch of ``b`` from those of the batch of 2
    (rows are independent: attention, the MoE groups, the scan) and of
    a cache of ``max_seq`` positions from a longer one (the positions
    past the decode steps are empty and masked)."""
    if stages is not None:
        return {k: v[:b] for k, v in stages.items()}
    return {k: (v[:, :b, :max_seq] if k in ("k", "v", "k_sc", "v_sc")
                else v[:, :b]) for k, v in cache.items()}


def blockwise_inputs(seed: int = 5):
    """q, k, v ``[1, 16, 4, 8]`` of the blockwise case (2 kv heads)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, 16, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 16, 2, 8)).astype(np.float32)
    return q, k, v


def _seq_forward(mesh, cfg, tree, rules, toks, fr, stages) -> dict:
    """The forward stage by stage: each stage gathered whole from this
    rank's block of the stream, the pass continued from the JAX stage's
    block; the tapped logits gathered whole."""
    import torch

    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as shd
    b, s = toks.shape
    n_front = cfg.img_tokens if cfg.family == "vlm" else 0
    dec = zoo.stream_layout((b, n_front + s, cfg.d_model), mesh, rules)
    enc = (zoo.stream_layout((b, cfg.enc_positions, cfg.d_model), mesh,
                             rules) if cfg.family == "encdec" else None)
    out = {"stages": {}, "stream": dec.axes}

    def tap(name, x):
        blk = enc if name.startswith("enc") else dec
        out["stages"][name] = shd.seq_gather(x, blk, 1, mesh).numpy()
        return shd.seq_take(torch.as_tensor(stages[name]), blk)
    t = torch.as_tensor(toks.astype(np.int64))
    f = None if fr is None else torch.as_tensor(fr)
    logits = zoo.forward(tree, cfg, t, frontend=f, tap=tap)
    lblk = zoo.logits_layout((b, s, cfg.vocab_padded), mesh, rules)
    out["logits"] = _whole(logits, (None, lblk.axes or None,
                                    zoo.vocab_axes(tree, cfg) or None),
                           mesh)
    return out


def _seq_decode(mesh, cfg, tree, rules, toks, caches, max_seq) -> dict:
    """The decode steps ``SEQ_STEPS``: each from the JAX cache before it
    laid out by ``cache_axes`` under ``rules``, and the same steps from
    the rank's own cache (starting from the JAX cache before the first),
    logits gathered whole; that cache's ``k`` gathered whole after the
    last step; the block shapes ``init_cache`` gives."""
    import torch

    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as shd
    cax = zoo.cache_axes(cfg)
    vspec = (None, None, zoo.vocab_axes(tree, cfg) or None)

    def lay(c):
        return shd.lay_out(c, {k: shd.resolve_spec(v.shape, cax[k], mesh,
                                                   rules)
                               for k, v in c.items()}, mesh, rules)
    t = torch.as_tensor(toks.astype(np.int64))
    out = {"dec": [], "free": []}
    own = lay(caches[SEQ_STEPS[0]])
    for i in SEQ_STEPS:
        logits, _ = zoo.decode_step(tree, cfg, t[:, i:i + 1],
                                    lay(caches[i]), i)
        out["dec"].append(_whole(logits, vspec, mesh))
        logits, own = zoo.decode_step(tree, cfg, t[:, i:i + 1], own, i)
        out["free"].append(_whole(logits, vspec, mesh).argmax(-1))
    if "k" in own:
        out["k_after"] = shd.relayout(own["k"], own.specs["k"], (),
                                      mesh)[0].float().numpy()
    cache = zoo.init_cache(cfg, toks.shape[0], max_seq, "cpu", mesh=mesh,
                           rules=rules)
    out["cache_specs"] = dict(cache.specs)
    out["cache_shapes"] = {k: tuple(v.shape) for k, v in cache.items()}
    return out


def _blockwise_on(mesh, mask: str) -> dict:
    """``blockwise_attention`` with ``kv_chunk`` 4 on this rank's block
    of q positions under ``cp_q`` over ``model`` (global positions for
    the mask; paligemma's prefix of 5 for ``prefix``)."""
    import torch

    from repro_torch.models import attention as attn
    from repro_torch.parallel import sharding as shd
    rules = seq_rules("cp_q")
    q, k, v = (torch.as_tensor(a) for a in blockwise_inputs())
    blk = shd.seq_block(q.shape, ("batch", "cp_q", "heads", None), 1,
                        mesh, rules)
    o = attn.blockwise_attention(shd.seq_take(q, blk), k, v, mask,
                                 5 if mask == "prefix" else 0, kv_chunk=4,
                                 q_offset=blk.start)
    return {"block": (blk.start, blk.size), "axes": blk.axes,
            "o": shd.seq_gather(o, blk, 1, mesh).numpy()}


RS_DTYPES = ("float32", "bfloat16")


def rs_input(rank: int, dtype: str):
    """World rank ``rank``'s operand of the reduce-scatter cases."""
    import torch
    return (torch.arange(32.0).reshape(4, 8) * (rank + 1)).to(
        getattr(torch, dtype))


def _reduce_scatters(meshes: dict, rank: int) -> dict:
    """``collectives.reduce_scatter`` of :func:`rs_input` over each axis
    of each mesh, along each dimension, in each of ``RS_DTYPES``; and
    this rank's coordinates on each mesh."""
    from repro_torch.parallel import collectives as cl
    out = {"coords": {k: dict(m.coords) for k, m in meshes.items()}}
    for k, m in meshes.items():
        for axis in m.shape:
            for dim in (0, 1):
                for dt in RS_DTYPES:
                    y = cl.reduce_scatter(rs_input(rank, dt), m, axis, dim)
                    out[k, axis, dim, dt] = (str(y.dtype),
                                             y.float().numpy())
    return out


def seq_layout_rank(mesh, ref_dir: str) -> dict:
    """The sequence layouts on one rank of a gloo world of 4 CPU ranks:
    every case of ``SEQ_CASES`` (the 1 x 4 world mesh, or the 2 x 2
    (data, model) mesh of ``elastic.remesh``), the blockwise cases and
    the reduce-scatters.
    The JAX parameters, stages (forward) and caches (decode) of the
    batch of 2 are published under ``ref_dir`` while the world runs
    (``params.pkl``, ``stages.pkl``, ``caches.pkl``, as ``{name:
    ...}``); the forward cases run first."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.core import convert
    from repro_torch.models import layers as ly
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import elastic
    torch.set_grad_enabled(False)
    meshes = {"1x4": mesh, "2x2": elastic.remesh(model_parallel=2,
                                                  device="cpu")}
    out = {"cases": {}, "blockwise": {},
           "reduce_scatter": _reduce_scatters(meshes, mesh.index)}
    for mask in BLOCKWISE_CASES:
        out["blockwise"][mask] = _blockwise_on(mesh, mask)
    ref = {"params": wait_pickle(os.path.join(ref_dir, "params.pkl"))}
    for layout, name, part in sorted(SEQ_CASES, key=lambda c: c[2] != "fwd"):
        m = meshes["2x2" if layout == "seq_data" else "1x4"]
        rules = seq_rules(layout)
        cfg = seq_cfg(registry, name)
        params = convert.params_from_numpy(ref["params"][name],
                                           device="cpu")
        _, axes = zoo.param_axes(cfg)
        tree = shd.lay_out(params, ly.axes_to_specs(params, axes, m, rules),
                           m, rules)
        b = seq_batch(layout)
        toks, fr = family_inputs(cfg)
        toks, fr = toks[:b], (None if fr is None else fr[:b])
        key = (layout, name, part)
        if part not in ref:
            ref[part] = wait_pickle(os.path.join(
                ref_dir, {"fwd": "stages.pkl", "dec": "caches.pkl"}[part]))
        if part == "fwd":
            out["cases"][key] = _seq_forward(
                m, cfg, tree, rules, toks, fr,
                seq_slice(b, 0, stages=ref["fwd"][name]))
        else:
            n = SEQ_CACHE[layout]
            out["cases"][key] = _seq_decode(
                m, cfg, tree, rules, toks,
                [seq_slice(b, n, cache=c) for c in ref["dec"][name]], n)
    return out


def relay_rank(mesh, flat: dict, specs22: dict, specs12: dict) -> dict:
    """``elastic.reshard`` across a change of mesh shape, on a rank of a
    4-rank world: the flat host tree ``flat`` laid out on the ``2 x 2``
    ``(data, model)`` mesh by ``specs22`` (fsdp over data), then on the
    ``1 x 2`` mesh of ranks 0 and 1 by ``specs12``; each rank's blocks
    and coordinates, and on the 2 x 2 mesh each weight's fsdp
    dimension gathered (``gather_param``)."""
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import elastic
    out = {}
    m22 = elastic.remesh(model_parallel=2, device="cpu")
    out["coords22"] = dict(m22.coords)
    b22 = elastic.reshard(flat, specs22, m22)
    out["b22"] = {k: v.numpy() for k, v in b22.items()}
    with shd.use_mesh(m22, shd.default_rules()):
        out["gathered"] = {
            k: shd.gather_param(b22[k], *names, spec=specs22[k]).numpy()
            for k, names in (("wq", ("layers", "fsdp", "heads")),
                             ("wo", ("layers", "heads", "fsdp")),
                             ("w_down", ("layers", "mlp", "fsdp")))}
    m12 = elastic.remesh([0, 1], model_parallel=2, device="cpu")
    out["coords12"] = None if m12 is None else dict(m12.coords)
    if m12 is not None:
        out["b12"] = {k: v.numpy() for k, v in
                      elastic.reshard(flat, specs12, m12).items()}
    return out


# ---------------------------------------------------------------------------
# GPipe and ppermute (tests/test_torch_pipeline.py)
# ---------------------------------------------------------------------------

PIPE_L, PIPE_D, PIPE_B = 8, 16, 8


def pipe_inputs(seed: int = 0):
    """The reference test's stack: ``w`` ``[L, D, D]`` and ``x``
    ``[B, D]``, float32."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(PIPE_L, PIPE_D, PIPE_D)).astype(np.float32) * 0.3
    x = rng.normal(size=(PIPE_B, PIPE_D)).astype(np.float32)
    return w, x


def pipe_stage(params_i, h):
    """One stage: its layers ``tanh(h @ w_i)`` in order."""
    import torch
    for wi in params_i.unbind(0):
        h = torch.tanh(h @ wi)
    return h


def pipeline_rank(mesh, cases) -> dict:
    """``pipeline_forward`` on the ``pod`` mesh of a gloo world, for each
    ``(n_microbatches, layout)`` of ``cases`` (``layout``: ``"block"``
    hands the rank its ``[1, ...]`` stage block, ``"stack"`` the whole
    ``[S, ...]`` stack); then ``ppermute`` by a ring, its reverse, a
    partial permutation and on a bfloat16 tensor."""
    import torch

    from repro_torch.parallel import collectives as cl
    from repro_torch.parallel import pipeline as pl
    from repro_torch.parallel import sharding as shd
    pod = shd.world_mesh(device="cpu", axis="pod")
    S = pod.shape["pod"]
    w, x = pipe_inputs()
    stages = pl.split_stages(torch.as_tensor(w), S)
    out = {"pipe": {}}
    for M, layout in cases:
        sp = (stages if layout == "stack"
              else shd.shard_tensor(stages, ("pod",), pod))
        out["pipe"][M, layout] = pl.pipeline_forward(
            torch.as_tensor(x), sp, pipe_stage, pod, M).numpy()
    me = pod.coords["pod"]
    v = torch.full((3,), float(me + 1))
    ring = [(i, (i + 1) % S) for i in range(S)]
    out["ring"] = cl.ppermute(v, pod, "pod", ring).tolist()
    out["back"] = cl.ppermute(v, pod, "pod",
                              [(d, s) for s, d in ring]).tolist()
    out["partial"] = cl.ppermute(v, pod, "pod", [(0, S - 1)]).tolist()
    out["bf16"] = cl.ppermute((v + 0.5).bfloat16(), pod, "pod",
                              ring).float().tolist()
    try:
        cl.ppermute(v, pod, "pod", [(0, 1), (1, 1)])
    except ValueError as e:
        out["refused"] = str(e)
    return out


# ---------------------------------------------------------------------------
# the sharded train step (tests/test_torch_train_mesh.py)
# ---------------------------------------------------------------------------

TRAIN_SHAPE = (2, 16)             # the step's batch x sequence
# (case, arch, mesh, layout, microbatch, compress): the 1 x 2 cases run
# on a world of 2 ranks, the 1 x 4 and 2 x 2 ones on a world of 4
TRAIN_CASES = (
    ("dense_heads", "qwen2-0.5b", "1x2", "default", 1, None),
    ("encdec", "whisper-large-v3", "1x2", "default", 1, None),
    ("vlm", "paligemma-3b", "1x2", "default", 1, None),
    ("int8", "qwen2-0.5b", "1x2", "default", 1, "int8"),
    ("dense_cp_q", "qwen2-0.5b", "1x4", "cp_q", 1, None),
    ("moe", "phi3.5-moe-42b-a6.6b", "1x4", "default", 1, None),
    ("hybrid", "zamba2-7b", "1x4", "default", 1, None),
    ("dense_fsdp", "qwen2-0.5b", "2x2", "default", 1, None),
    ("microbatch", "qwen2-0.5b", "2x2", "default", 2, None),
    ("topk", "phi3.5-moe-42b-a6.6b", "2x2", "default", 1, "topk"),
)
TRANSPOSE_KINDS = ("all_gather", "all_gather_tiled", "psum",
                   "reduce_scatter_0", "reduce_scatter_1", "all_to_all",
                   "ppermute")


def train_batch_of(cfg, microbatch: int, seed: int = 7) -> dict:
    """The step's batch (numpy): ``TRAIN_SHAPE`` ids from ``seed``, the
    labels the ids, the stub frontend where the family has one (as
    ``tests/test_torch_train.py`` draws them); for ``microbatch`` 2 a
    batch of 4 rows whose labels hold -1 at a few positions inside rows
    (the microbatches then hold different label counts)."""
    rng = np.random.default_rng(seed)
    b, s = TRAIN_SHAPE[0] * (2 if microbatch > 1 else 1), TRAIN_SHAPE[1]
    toks = rng.integers(1, cfg.vocab, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks.copy()}
    if microbatch > 1:
        batch["labels"][0, 3:9] = -1
        batch["labels"][3, 5] = -1
    n = {"encdec": cfg.enc_positions, "vlm": cfg.img_tokens}.get(cfg.family)
    if n is not None:
        batch["frontend"] = (0.02 * rng.standard_normal(
            (b, n, cfg.d_model))).astype(np.float32)
    return batch


def train_rules(layout: str):
    from repro_torch.parallel import sharding as shd
    rules = shd.default_rules()
    if layout == "cp_q":
        rules["cp_seq"] = ("model",)
        rules["cp_q"] = ("model",)
    return rules


def _train_case(mesh, case, params_np) -> dict:
    """One case of ``TRAIN_CASES`` on this rank: the JAX parameters laid
    out on ``mesh``, the gradients (``train_step._value_and_grad``) and
    one step of ``make_train_step``; each leaf of the gradients, the new
    parameters and the moments gathered whole, this rank's gradient
    blocks and the leaves' specs."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.core import convert
    from repro_torch.core.tree import leaves
    from repro_torch.models import layers as ly
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    name, arch, _, layout, mb, compress = case
    cfg = registry.get_smoke(arch)
    rules = train_rules(layout)
    params = convert.params_from_numpy(params_np, device="cpu")
    _, axes = zoo.param_axes(cfg)
    tree = shd.lay_out(params, ly.axes_to_specs(params, axes, mesh, rules),
                       mesh, rules)
    batch = train_batch_of(cfg, mb)
    rows, _ = _rows(mesh, rules, batch["tokens"].shape[0])
    tb = {k: torch.as_tensor(v[rows].astype(np.int64) if v.dtype == np.int32
                             else v[rows]) for k, v in batch.items()}
    loss, grads = ts._value_and_grad(tree, cfg, tb, mb)
    out = ts.make_train_step(cfg, microbatch=mb, compress=compress)(
        tree, opt.init(tree), tb)
    new, state, metrics = out[:3]
    specs = shd.spec_leaves(tree.specs)

    def whole(t):
        return [_whole(x, sp, mesh) for x, sp in zip(leaves(t), specs)]
    return {"loss": float(loss), "m_loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "grads": whole(grads), "params": whole(new),
            "mu": whole(state.mu), "nu": whole(state.nu),
            "step": int(state.step), "specs": specs,
            "blocks": [g.numpy() for g in leaves(grads)],
            "is_laid_out": [isinstance(t, shd.LaidOutTree)
                            for t in (grads, new, state.mu, state.nu)]
            + ([isinstance(out[3], shd.LaidOutTree)] if compress else [])}


def transpose_input(kind: str, rank: int, dtype: str, shape=(4, 8)):
    """World rank ``rank``'s operand and cotangent of one transpose
    case: small integers (exact in bfloat16, their sums too) scaled to
    halves."""
    rng = np.random.default_rng(100 * rank + TRANSPOSE_KINDS.index(kind))
    x = rng.integers(-4, 5, shape).astype(np.float64) / 2
    ct = rng.integers(-4, 5, (4,) + shape if kind == "all_gather"
                      else shape).astype(np.float64) / 2
    return x.astype(dtype), ct.astype(dtype)


def _transposes(meshes: dict, rank: int) -> dict:
    """For each differentiable collective (``TRANSPOSE_KINDS``) over each
    axis of more than one rank of each mesh, in float64 and bfloat16:
    ``<ct, f(x)>`` and ``<f^T(ct), x>`` on this rank (float64 sums), with
    ``f^T(ct)`` from ``torch.autograd.grad``."""
    import torch

    from repro_torch.parallel import collectives as cl
    out = {}
    for key, m in meshes.items():
        for axis, n in m.shape.items():
            if n == 1:
                continue
            ring = [(i, (i + 1) % n) for i in range(n)]
            fns = {"all_gather": lambda x: cl.all_gather(x, m, axis),
                   "all_gather_tiled": lambda x: cl.all_gather_tiled(
                       x, m, axis),
                   "psum": lambda x: cl.psum(x, m, axis),
                   "reduce_scatter_0": lambda x: cl.reduce_scatter(
                       x, m, axis, 0),
                   "reduce_scatter_1": lambda x: cl.reduce_scatter(
                       x, m, axis, 1),
                   "all_to_all": lambda x: cl.all_to_all(x, m, axis),
                   "ppermute": lambda x: cl.ppermute(x, m, axis, ring)}
            for kind in TRANSPOSE_KINDS:
                for dt in ("float64", "bfloat16"):
                    xa, cta = transpose_input(kind, rank, "float64")
                    tdt = getattr(torch, dt)
                    x = torch.as_tensor(xa).to(tdt).requires_grad_(True)
                    y = fns[kind](x)
                    ct = torch.as_tensor(cta).to(tdt)
                    if kind == "all_gather":
                        ct = ct[:n]
                    elif kind == "all_gather_tiled":
                        ct = ct.repeat(n, 1)
                    elif kind.startswith("reduce_scatter"):
                        ct = ct.narrow(int(kind[-1]), 0, ct.shape[
                            int(kind[-1])] // n)
                    xt, = torch.autograd.grad(y, x, ct)
                    out[key, axis, kind, dt] = (
                        float((ct.double() * y.double()).sum()),
                        float((xt.double() * x.double()).sum()),
                        str(y.dtype), str(xt.dtype))
    return out


def train_mesh_rank(mesh, params_np: dict) -> dict:
    """The sharded train step on one rank of a gloo world of 2 or 4 CPU
    ranks: the transpose cases of every differentiable collective, then
    each case of ``TRAIN_CASES`` on this world's meshes (``1 x S``, and
    with 4 ranks the ``2 x 2`` (data, model) mesh), from the JAX
    parameters ``params_np[arch]``."""
    from repro_torch.train import elastic
    S = mesh.shape["model"]
    meshes = {f"1x{S}": mesh}
    if S == 4:
        meshes["2x2"] = elastic.remesh(model_parallel=2, device="cpu")
    out = {"coords": {k: dict(m.coords) for k, m in meshes.items()},
           "transpose": _transposes(meshes, mesh.index), "cases": {}}
    for case in TRAIN_CASES:
        if case[2] in meshes:
            out["cases"][case[0]] = _train_case(meshes[case[2]], case,
                                                params_np[case[1]])
    return out


# ---------------------------------------------------------------------------
# the benchmark twins (tests/test_torch_probes.py, test_torch_chaos_probe.py,
# test_torch_serving_probe.py)
# ---------------------------------------------------------------------------

def auto_axes_make_mesh() -> None:
    """Make ``jax.make_mesh`` build ``jax.sharding.Mesh`` host meshes,
    whose axes are Auto, in this process only: the reference probes
    build their meshes with ``jax.make_mesh``, which gives Explicit
    axes under jax 0.9 that the JAX package's sharded code refuses."""
    import math

    import jax

    def make_mesh(shape, names, **_):
        n = math.prod(shape)
        return jax.sharding.Mesh(
            np.array(jax.devices()[:n]).reshape(tuple(shape)), tuple(names))
    jax.make_mesh = make_mesh


def write_pickle(path: str, value) -> None:
    """Publish ``value`` at ``path`` whole (another process may poll)."""
    with open(path + ".tmp", "wb") as f:
        pickle.dump(value, f)
    os.replace(path + ".tmp", path)


def wait_pickle(path: str, timeout: float = 900.0):
    """The value another process publishes at ``path``."""
    import time
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def probe_bench_rank(mesh, shapes: dict) -> dict:
    """The ``run_bench`` of each of the three sharded probes' twins on
    one rank, ``{probe: result}`` for ``shapes`` ``{probe: kwargs}``."""
    import importlib
    return {name: importlib.import_module(
        f"repro_torch.benchmarks.{name}").run_bench(mesh, **kw)
        for name, kw in shapes.items()}


def serving_probe_rank(mesh, params_np: dict, bench_kw: dict) -> dict:
    """``serving_probe.run_parity`` and ``run_bench(**bench_kw)`` on one
    rank, with the JAX package's smoke weights ``params_np``."""
    from repro_torch.benchmarks import serving_probe as sp
    from repro_torch.core import convert
    params = convert.params_from_numpy(params_np, device=mesh.device)
    return {"parity": sp.run_parity(mesh, params=params),
            "bench": sp.run_bench(mesh, params=params, **bench_kw)}


def jax_main(suite: str, S: int, part: str, out_path: str) -> None:
    """One part of the JAX side at one shard count, in a process of its
    own: the suite on a mesh of ``S`` of the host's 4 forced devices
    (``jax.sharding.Mesh``, whose axes are Auto), pickled to
    ``out_path``."""
    P = JaxPkg()
    res = _run_suite(P, suite, S,
                     tempfile.mkdtemp(prefix=f"mesh-jax-{S}-"),
                     part if part != "all" else None)
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def run_both(suite: str, tmp: str):
    """Both sides of a suite: ``(jax {S: cases}, torch {S: [per-rank
    cases]})``.  The JAX side runs one process per shard count and part,
    all while the port's worlds run."""
    from repro_torch.launch import spmd
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(REPO, "src"), os.path.join(REPO, "tests")]))
    procs = []
    for S in SHARDS:
        for part in PARTS.get(suite, {"all": None}):
            path = os.path.join(tmp, f"jax-{suite}-{S}-{part}.pkl")
            procs.append((S, path, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), suite, str(S),
                 part, path], cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    try:
        port = {}
        for S in SHARDS:
            d = os.path.join(tmp, f"torch-{S}")
            os.makedirs(d)
            port[S] = spmd.spawn(torch_rank, S, suite, d, device="cpu",
                                 threads=1, timeout=600)
        ref = {S: {} for S in SHARDS}
        for S, path, proc in procs:
            log, _ = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"JAX reference, S={S}, failed:\n{log}")
            with open(path, "rb") as f:
                ref[S].update(pickle.load(f))
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return ref, port


def assert_same(a, b, msg: str) -> None:
    """Two case results equal bit for bit: arrays in dtype, shape and
    every element, everything else by ``==``."""
    assert sorted(a) == sorted(b), (msg, sorted(a), sorted(b))
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, \
                (msg, k, x.dtype, y.dtype, x.shape, y.shape)
            np.testing.assert_array_equal(x, y, err_msg=f"{msg} {k}")
        else:
            assert x == y, (msg, k, x, y)


if __name__ == "__main__":
    jax_main(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])

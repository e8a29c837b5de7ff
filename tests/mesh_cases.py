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

"""Paged KV-cache pool with a splay-list page index: the twin of
``repro.serve.kv_cache``.

Pages of ``page_size`` positions are pooled; each session owns a chain
of pages.  The session index is a splay-list, an ordered index: it
answers membership, ``predecessor`` and ``lookup_range`` over the live
session ids.  Two index backends:

* **host** (``device=False``, the default): the pure-Python
  ``core.ref_py.SplayList``, one walk per call;
* **device** (``device=True``): a ``core.splaylist`` state and its index
  plane, as tensors on ``torch_device`` (the card unless the caller
  passes ``"cpu"``).  Creates and releases buffer on the host and flush
  through ``run_epoch`` op epochs (kernel F, then the plane refresh)
  before any lookup, so the plane a lookup reads is an exact snapshot
  of the live set; lookups batch through plane-search epochs (the
  descent engine B1/B2), predecessor queries through ordered epochs and
  range queries through ``splay_range_scan``.  With a ``mesh``
  (``parallel.sharding.Mesh``; every rank of it holds the pool and makes
  the same calls) the plane is laid out width-sharded, lookups take the
  routed sharded search, and the route controller steers each lookup
  epoch's slack and split from its ``[S]`` occupancy.  Both backends
  answer every call identically.

Page bookkeeping (free list, chains, lengths) stays on the host in both
modes.

Fault tolerance, device mode: with ``audit_every=K`` the pool audits
``(state, plane)`` (``core.plane_check``) every K lookup entries, and on
every entry while degraded.  On a failed audit it repairs the plane
with one full-rebuild epoch from the state and audits again; a plane
that stays wrong pins the pool to rung 2, the host ``SplayList`` oracle,
so a corrupted plane never answers.  The pool climbs back one rung per
clean pass (rung 1 answers a sharded lookup through the masked trace;
meshless it answers as rung 0).  A shard loss rebuilds the plane from
the state and lays it out on the survivors (:meth:`on_shard_loss`).  A
``core.faults.FaultPlan`` injects its events between the mutation flush
and the lookup answer.  All of it is counted in ``stats``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.ref_py import SplayList


class PagedKVPool:
    """``device=False`` keeps the host index.  ``device=True`` indexes
    sessions on a splay state and plane placed on ``torch_device``:
    ``index_width`` bounds the live sessions the plane can represent
    (``create`` returns ``False`` at the bound; the default rounds
    ``max(n_pages, 64)`` up to a multiple of 8), and ``index_batch`` is
    the width of every op and lookup epoch (``pad_op_batch`` pads each
    chunk to it).  ``mesh``/``axis`` lay the plane out width-sharded and
    route lookups through the all-to-all exchange; ``index_width`` must
    then divide into the mesh's shards.  ``torch_device`` defaults to
    the mesh's device, else the card."""

    def __init__(self, n_pages: int, page_size: int, max_level: int = 24,
                 p: float = 0.1, device: bool = False,
                 index_width: int = None, index_batch: int = 32,
                 mesh=None, axis: str = "model",
                 audit_every: int = 0, fault_plan=None,
                 torch_device=None):
        self.axis = axis
        self.n_pages = n_pages
        self.page_size = page_size
        self.free: List[int] = list(range(n_pages))
        self.chains: Dict[int, List[int]] = {}
        self.lengths: Dict[int, int] = {}
        self.device = bool(device)
        self._max_level = int(max_level)
        self._p = float(p)
        self.stats = {"lookups": 0, "plane_queries": 0, "plane_epochs": 0,
                      "flush_epochs": 0, "spill": 0, "rebuilds": 0,
                      "create_rejects": 0, "range_queries": 0,
                      "range_truncated": 0, "pred_queries": 0,
                      "audits": 0, "audit_failures": 0, "repairs": 0,
                      "degraded_masked": 0, "degraded_host": 0,
                      "remeshes": 0, "telemetry_dropped": 0,
                      "faults_injected": 0}
        self.audit_every = int(audit_every)
        self.fault_plan = fault_plan
        self.last_audit = None
        self._rung = 0                 # 0 routed, 1 masked, 2 host oracle
        self._oracle = None            # rung-2 SplayList mirror
        self._lookup_no = 0            # lookup-epoch counter (fault key)
        self._since_audit = 0
        self._telemetry_until = 0      # lookup epoch the blackout ends at
        self._last_ctrl_occ = None     # last occupancy the controller saw
        self._fired: set = set()       # one-shot fault-event indices
        if not self.device:
            self.index = SplayList(max_level=max_level, p=p)
            return
        from repro_torch.core import device_index as dix
        from repro_torch.core import route_controller as rc
        from repro_torch.core import splaylist as sx
        from repro_torch.parallel import sharding as shd
        self._sx, self._dix, self._rc, self._shd = sx, dix, rc, shd
        shd.check_mesh(mesh)
        self.mesh = mesh
        n_shards = (int(mesh.shape[axis])
                    if mesh is not None and axis in mesh.shape else 1)
        if index_width is None:
            index_width = -(-max(n_pages, 64) // 8) * 8
        if mesh is not None and index_width % n_shards:
            raise ValueError(
                f"index_width={index_width} not divisible by the "
                f"{n_shards}-shard mesh axis {axis!r}")
        if torch_device is None:
            torch_device = mesh.device if mesh is not None else "cuda"
        self.index_width = int(index_width)
        self.index_batch = int(index_batch)
        self._sharded = mesh is not None and n_shards > 1
        # the ranks a shard loss shrinks from: every rank of the mesh
        # keeps the list, survivor or not, so all make the same remesh
        self._survivors = list(mesh.ranks) if mesh is not None else None
        self._st = sx.make(self.index_width + 2, max_level=max_level,
                           device=torch_device)
        self._plane = dix.from_state_device(
            self._st, n_levels=max_level, width=self.index_width)
        if self._sharded:
            self._plane = shd.shard_index_plane(self._plane, mesh, axis)
        self.ctrl_cfg, self.ctrl = rc.init_controller(n_shards)
        self._pending: List[tuple] = []   # (OP_INSERT|OP_DELETE, seq_id)
        self._rebuild_pending = False
        self._pressed = False
        self.last_occupancy = np.zeros(max(n_shards, 1), np.int64)
        self.spill_traj: List[int] = []   # per plane-epoch spill counts
        self.share_traj: List[float] = []  # per plane-epoch max-share

    # -- device epochs ----------------------------------------------------

    def _epoch(self, kinds, keys, upd, aggregate, plane_search,
               ordered=False, routed=True):
        """One padded op or lookup epoch through ``run_epoch``, stepping
        the overflow machine and, on lookup epochs, the controller.
        ``routed=False`` answers a sharded lookup through the masked
        trace (rung 1 of the degradation ladder)."""
        sx, rc = self._sx, self._rc
        B = kinds.shape[0]
        rebuild = self._rebuild_pending or self.ctrl.force_rebuild
        if rebuild:
            self.stats["rebuilds"] += 1
        sharded = self._sharded
        st, plane, res, plen, ovf, spl, occ = sx.run_epoch(
            self._st, self._plane, kinds, keys, upd,
            aggregate=aggregate, rebuild=rebuild,
            mesh=self.mesh if sharded else None, axis=self.axis,
            plane_search=plane_search,
            split=self.ctrl.split if sharded else "lanes",
            route_slack=(self.ctrl.slack_of(self.ctrl_cfg)
                         if sharded else None),
            ordered=ordered, routed=routed)
        self._st, self._plane = st, plane
        self._rebuild_pending, self._pressed = rc.overflow_machine_step(
            int(ovf), int(st.size), B, self.index_width, self._pressed)
        if plane_search:
            occ = occ.cpu().numpy().astype(np.int64)
            self.stats["plane_epochs"] += 1
            self.stats["spill"] += int(spl)
            self.last_occupancy = occ
            self.spill_traj.append(int(spl))
            self.share_traj.append(rc.max_share(occ))
            if self._lookup_no < self._telemetry_until:
                # telemetry blackout: the controller sees zero spill and
                # the last delivered occupancy; serving stays correct
                from repro_torch.core import faults as fl
                self.stats["telemetry_dropped"] += 1
                spl_fb, occ_fb = fl.mangle_telemetry(
                    int(spl), occ, self._last_ctrl_occ)
            else:
                spl_fb, occ_fb = int(spl), occ
                self._last_ctrl_occ = occ_fb
            self.ctrl = rc.controller_step(
                self.ctrl_cfg, self.ctrl, spl_fb, occ_fb, B)
        else:
            self.stats["flush_epochs"] += 1
            # flush epochs route nothing; still clear a one-shot rebuild
            self.ctrl = self.ctrl._replace(force_rebuild=False)
        return res.cpu().numpy()

    def _flush(self) -> None:
        """Apply the buffered creates and releases (op epochs with a
        plane refresh), so the next lookup reads an exact snapshot."""
        if not self.device or not self._pending:
            return
        if self._rung >= 2:
            # the plane is still corrupt: rebuild from the state on
            # every flush until an audit passes
            self._rebuild_pending = True
        sx = self._sx
        ops, self._pending = self._pending, []
        B = self.index_batch
        for i in range(0, len(ops), B):
            chunk = ops[i:i + B]
            kinds = np.fromiter((k for k, _ in chunk), np.int32,
                                len(chunk))
            keys = np.fromiter((s for _, s in chunk), np.int32,
                               len(chunk))
            kd, ks, up, _ = sx.pad_op_batch(
                kinds, keys, np.ones(len(chunk), bool), B)
            self._epoch(kd, ks, up, aggregate=False, plane_search=False)

    # -- fault tolerance: audit, ladder, fault hooks ----------------------

    def _plane_segments(self) -> int:
        if self._sharded and self._dix.plane_is_segmented(self._plane):
            return int(self.mesh.shape[self.axis])
        return 1

    def audit(self):
        """Audit the current ``(state, plane)`` pair; returns the
        ``PlaneAudit`` (also kept as ``self.last_audit``)."""
        from repro_torch.core import plane_check as pcheck
        a = pcheck.audit_plane(self._st, self._plane,
                               n_segments=self._plane_segments())
        self.stats["audits"] += 1
        self.last_audit = a
        return a

    def _repair_epoch(self) -> None:
        """One forced full-rebuild epoch over an all-pad (read-only)
        batch: the plane is rebuilt from the state."""
        sx = self._sx
        self._rebuild_pending = True
        kd, ks, up, _ = sx.pad_op_batch(
            np.empty(0, np.int32), np.empty(0, np.int32),
            np.empty(0, bool), self.index_batch)
        self._epoch(kd, ks, up, aggregate=False, plane_search=False)

    def _consume_faults(self) -> None:
        """Fire this lookup epoch's scheduled events, each once, between
        the mutation flush and the lookup answer."""
        if self.fault_plan is None:
            return
        from repro_torch.core import faults as fl
        for i, ev in enumerate(self.fault_plan.events):
            if ev.epoch != self._lookup_no or i in self._fired:
                continue
            self._fired.add(i)
            self.stats["faults_injected"] += 1
            if ev.family == fl.FAULT_CRASH:
                raise fl.InjectedCrash(
                    f"injected crash at lookup epoch {self._lookup_no}")
            if ev.family == fl.FAULT_BITFLIP:
                self._plane, _ = fl.flip_plane_bits(
                    self._plane, self.fault_plan.rng_for(ev), ev.arg)
            elif ev.family == fl.FAULT_SHARD_LOSS:
                self.on_shard_loss(ev.arg)
            elif ev.family == fl.FAULT_TELEMETRY:
                self._telemetry_until = self._lookup_no + max(ev.arg, 1)

    def _audit_gate(self) -> bool:
        """Audit when due; on a failure repair and audit again.  True
        when the plane is now clean; a plane still wrong after the
        repair pins the pool at rung 2."""
        if not self.device or self.audit_every <= 0:
            return True
        self._since_audit += 1
        if self._rung == 0 and self._since_audit < self.audit_every:
            return True
        self._since_audit = 0
        from repro_torch.core import plane_check as pcheck
        if pcheck.audit_ok(self.audit()):
            return True
        self.stats["audit_failures"] += 1
        self._rung = max(self._rung, 1)
        self._repair_epoch()
        if pcheck.audit_ok(self.audit()):
            self.stats["repairs"] += 1
            return True
        self._rung = 2
        return False

    def _pre_lookup(self) -> bool:
        """Flush, fire scheduled faults (may raise ``InjectedCrash``),
        then gate on the audit."""
        self._flush()
        self._consume_faults()
        return self._audit_gate()

    def _post_lookup(self, clean: bool) -> None:
        """Climb one rung per clean pass."""
        self._lookup_no += 1
        if clean and self._rung > 0:
            self._rung -= 1
            if self._rung == 0:
                self._oracle = None

    def _oracle_contains(self, chunk) -> np.ndarray:
        """Rung 2: membership from a host ``SplayList`` mirror of the
        live sessions (built from ``chains`` on first use, kept in sync
        by ``create``/``release``)."""
        if self._oracle is None:
            self._oracle = SplayList(max_level=self._max_level, p=self._p)
            for s in sorted(self.chains):
                self._oracle.insert(int(s))
        return np.array([self._oracle.contains(int(s)) for s in chunk],
                        bool)

    def on_shard_loss(self, n_survivors: int) -> None:
        """Shrink the serving mesh to its first ``n_survivors`` ranks:
        the lost blocks are gone, so the plane is rebuilt from the
        state (every rank holds it whole) and laid out on the
        survivors' mesh (``train.elastic.remesh``), or kept replicated
        when fewer than two survive or the width does not divide.  Every
        rank of the old mesh calls this (``remesh`` is collective); a
        rank outside the survivors goes on meshless with its own
        replicated state, answering as before but joining no collective.
        The controller restarts for the new shard count and the pool
        serves at least one masked epoch (rung 1) before climbing back.
        """
        self.stats["remeshes"] += 1
        n = max(int(n_survivors), 1)
        mesh = None
        if self._survivors is not None:
            from repro_torch.train import elastic
            self._survivors = self._survivors[:n]
            if n > 1 and self.index_width % n == 0 \
                    and len(self._survivors) == n:
                mesh = elastic.remesh(self._survivors, model_parallel=n,
                                      device=self._st.device,
                                      axis=self.axis)
        self.mesh = mesh
        n_shards = int(mesh.shape[self.axis]) if mesh is not None else 1
        self._sharded = mesh is not None and n_shards > 1
        self._plane = self._dix.from_state_device(
            self._st, n_levels=self._max_level, width=self.index_width)
        if self._sharded:
            self._plane = self._shd.shard_index_plane(self._plane, mesh,
                                                      self.axis)
        self.ctrl_cfg, self.ctrl = self._rc.init_controller(n_shards)
        self.last_occupancy = np.zeros(max(n_shards, 1), np.int64)
        self._last_ctrl_occ = None
        self._rung = max(self._rung, 1)

    def lookup_batch(self, seq_ids) -> np.ndarray:
        """Vector membership: ``out[i]`` iff ``seq_ids[i]`` is a live
        session.  Device mode answers from the plane in
        ``index_batch``-padded epochs; host mode walks the list per
        id."""
        seq_ids = np.asarray(seq_ids, np.int64).ravel()
        self.stats["lookups"] += seq_ids.size
        if not self.device:
            return np.array([self.index.contains(int(s))
                             for s in seq_ids], bool)
        clean = self._pre_lookup()
        sx = self._sx
        out = np.zeros(seq_ids.size, bool)
        B = self.index_batch
        for i in range(0, seq_ids.size, B):
            chunk = seq_ids[i:i + B].astype(np.int32)
            if self._rung >= 2:
                n = chunk.size
                out[i:i + n] = self._oracle_contains(chunk)
                self.stats["degraded_host"] += n
                continue
            kd, ks, up, n = sx.pad_op_batch(
                np.full(chunk.size, sx.OP_CONTAINS, np.int32), chunk,
                np.ones(chunk.size, bool), B)
            res = self._epoch(kd, ks, up, aggregate=True,
                              plane_search=True, routed=self._rung == 0)
            out[i:i + n] = res[:n]
            self.stats["plane_queries"] += n
            if self._rung == 1:
                self.stats["degraded_masked"] += n
        self._post_lookup(clean)
        return out

    def _host_predecessor(self, seq_id: int) -> Optional[int]:
        cand = [s for s in self.chains if s <= seq_id]
        return max(cand) if cand else None

    def predecessor(self, seq_id: int) -> Optional[int]:
        """Largest live session id ``<= seq_id``, or ``None``.  Device
        mode answers from the plane through an ordered ``OP_PRED`` epoch;
        host mode scans the live-session metadata."""
        self.stats["pred_queries"] += 1
        if not self.device:
            return self._host_predecessor(seq_id)
        clean = self._pre_lookup()
        if self._rung >= 2:
            self.stats["degraded_host"] += 1
            self._post_lookup(clean)
            return self._host_predecessor(seq_id)
        sx = self._sx
        kd, ks, up, _ = sx.pad_op_batch(
            np.array([sx.OP_PRED], np.int32),
            np.array([int(seq_id)], np.int32), np.zeros(1, bool),
            self.index_batch)
        res = self._epoch(kd, ks, up, aggregate=True, plane_search=True,
                          ordered=True, routed=self._rung == 0)
        self.stats["plane_queries"] += 1
        if self._rung == 1:
            self.stats["degraded_masked"] += 1
        self._post_lookup(clean)
        pred = int(res[0])
        return None if pred == sx.NEG_INF_32 else pred

    def _host_range(self, lo: int, hi: int, max_range: int):
        ids = np.asarray(sorted(s for s in self.chains if lo <= s <= hi),
                         np.int64)
        count = ids.size
        truncated = max(count - max_range, 0)
        self.stats["range_truncated"] += truncated
        return ids[:max_range], count, truncated

    def lookup_range(self, lo: int, hi: int, max_range: int = None):
        """Live session ids in ``[lo, hi]``, ascending: ``(ids int64[n],
        count, truncated)`` with ``n = min(count, max_range)``; ``count``
        is the full population and ``truncated`` what the capacity cut.
        ``max_range`` defaults to ``index_batch`` (32 in host mode).
        Device mode is one ``splay_range_scan`` over the flushed plane
        (sharded on a laid-out one)."""
        if max_range is None:
            max_range = self.index_batch if self.device else 32
        self.stats["range_queries"] += 1
        if not self.device:
            return self._host_range(lo, hi, max_range)
        clean = self._pre_lookup()
        if self._rung >= 2:
            self.stats["degraded_host"] += 1
            self._post_lookup(clean)
            return self._host_range(lo, hi, max_range)
        from repro_torch.kernels import ops as kops
        dev = self._st.device
        keys, cnt, tr = kops.splay_range_scan(
            self._plane, torch.tensor([int(lo)], dtype=torch.int32,
                                      device=dev),
            torch.tensor([int(hi)], dtype=torch.int32, device=dev),
            max_range=int(max_range))
        self.stats["plane_queries"] += 1
        if self._rung == 1:
            self.stats["degraded_masked"] += 1
        self._post_lookup(clean)
        count, truncated = int(cnt[0]), int(tr[0])
        self.stats["range_truncated"] += truncated
        ids = keys[0].cpu().numpy().astype(np.int64)[:min(count, max_range)]
        return ids, count, truncated

    # -- pool API ---------------------------------------------------------

    def create(self, seq_id: int) -> bool:
        if seq_id in self.chains:
            return False
        if self.device and len(self.chains) >= self.index_width:
            # the plane cannot represent another live session: refuse
            # admission rather than let the index go stale
            self.stats["create_rejects"] += 1
            return False
        self.chains[seq_id] = []
        self.lengths[seq_id] = 0
        if self.device:
            self._pending.append((self._sx.OP_INSERT, int(seq_id)))
            if self._oracle is not None:
                self._oracle.insert(int(seq_id))
        else:
            self.index.insert(seq_id)
        return True

    def lookup(self, seq_id: int) -> Optional[List[int]]:
        """Splay-indexed session lookup: its page chain, or ``None``."""
        if not self.lookup_batch([seq_id])[0]:
            return None
        return self.chains.get(seq_id)

    def append_tokens(self, seq_id: int, n: int) -> bool:
        """Reserve page space for ``n`` more positions.  ``False`` when
        the free list ran dry midway; pages already chained stay
        reserved."""
        assert seq_id in self.chains
        need = (self.lengths[seq_id] + n + self.page_size - 1) \
            // self.page_size
        while len(self.chains[seq_id]) < need:
            if not self.free:
                return False
            self.chains[seq_id].append(self.free.pop())
        self.lengths[seq_id] += n
        return True

    def release(self, seq_id: int) -> None:
        if seq_id in self.chains:
            self.free.extend(self.chains.pop(seq_id))
            self.lengths.pop(seq_id, None)
            if self.device:
                self._pending.append((self._sx.OP_DELETE, int(seq_id)))
                if self._oracle is not None:
                    self._oracle.delete(int(seq_id))
            else:
                self.index.delete(seq_id)

    def page_table(self, seq_id: int, max_pages: int) -> np.ndarray:
        chain = self.chains.get(seq_id, [])
        out = np.full(max_pages, -1, np.int32)
        out[:len(chain)] = chain
        return out

    @property
    def utilization(self) -> float:
        return 1.0 - len(self.free) / self.n_pages

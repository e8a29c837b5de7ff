"""Closed-loop routing controller of the serving loop: the twin of
``repro.core.route_controller``.

The width-sharded search's routed query exchange has a static
per-shard receive block (``route_capacity = ceil(q/S) · slack``).  This
host-side controller folds each epoch's feedback (``spill`` and the
per-shard ``occupancy`` that ``run_epoch`` returns) into an EWMA and
steers the next epoch:

(a) ``route_slack`` moves along a quantized ladder with a wide
    hysteresis band (grow above ``high_water · capacity``, shrink only
    below ``low_water`` of the lower rung's capacity);
(b) spill or an occupancy Gini past a threshold escalates the refresh
    to the mass-weighted re-split (``split="mass"``), and a re-split
    that stays imbalanced for ``rebuild_patience`` epochs asks for a
    full plane rebuild;
(c) a long enough calm streak de-escalates back to the equal-lane
    refresh, with a doubling backoff.

Everything is plain host math over concrete numbers, the same on
every rank of a mesh (the statistics are replicated).  Meshless (a
``[1]`` occupancy vector) the controller observes and never actuates,
and :func:`run_serving_controlled` is exactly the replicated
``run_serving``.  :func:`overflow_machine_step` is the host step of
``run_serving``'s overflow state machine, shared by every host-stepped
epoch loop (``run_serving`` itself, the controlled loop and the
device-indexed ``serve.kv_cache.PagedKVPool``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels.splay_search import (DEFAULT_ROUTE_SLACK,
                                              route_capacity)

__all__ = [
    "ControllerConfig", "ControllerState", "default_slack_ladder",
    "init_controller", "controller_step", "controller_to_dict",
    "controller_from_dict", "overflow_machine_step",
    "run_serving_controlled", "max_share", "routing_gini",
]


def overflow_machine_step(overflow: int, size: int, batch: int,
                          width: int, pressed: bool
                          ) -> Tuple[bool, bool]:
    """One step of the overflow state machine: given this epoch's
    refresh ``overflow``, the post-epoch alive ``size``, the epoch
    ``batch``, the plane ``width`` and the near-full latch ``pressed``,
    return ``(pending, pressed')``: whether the next epoch must take the
    full-rebuild branch (an overflow, or the alive count entering the
    zone within one batch of the width, edge-triggered), and the
    updated latch."""
    pressure = int(size) + int(batch) > int(width)
    pending = int(overflow) > 0 or (pressure and not pressed)
    return pending, pressure


# ---------------------------------------------------------------------------
# balance statistics
# ---------------------------------------------------------------------------

def max_share(occupancy) -> float:
    """Largest shard's fraction of the live queries (1/S = balanced,
    1.0 = one owner)."""
    occ = np.asarray(occupancy, np.float64)
    tot = occ.sum()
    return float(occ.max() / tot) if tot > 0 else 0.0


def routing_gini(occupancy) -> float:
    """Gini coefficient of the per-shard occupancy vector (0 = balanced,
    towards 1 = all load on one shard)."""
    x = np.sort(np.asarray(occupancy, np.float64))
    n = x.size
    tot = x.sum()
    if tot == 0 or n < 2:
        return 0.0
    return float((2 * np.arange(1, n + 1) - n - 1).dot(x) / (n * tot))


# ---------------------------------------------------------------------------
# configuration / state
# ---------------------------------------------------------------------------

def default_slack_ladder(n_shards: int,
                         base: float = DEFAULT_ROUTE_SLACK,
                         growth: float = 1.5) -> Tuple[float, ...]:
    """The quantized slack rungs ``1.0, base, base·g, ...`` capped at
    ``n_shards`` (where the capacity clamps at ``q`` and spill is
    impossible)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    top = float(n_shards)
    rungs = [1.0]
    s = base
    while s < top and len(rungs) < 16:
        if s > rungs[-1]:
            rungs.append(float(s))
        s *= growth
    if rungs[-1] < top:
        rungs.append(top)
    return tuple(rungs)


class ControllerConfig(NamedTuple):
    """Gains and thresholds; every comparison is strict on the hot
    side, so a workload exactly on a threshold does not actuate."""
    slack_ladder: Tuple[float, ...]   # quantized route_slack rungs
    ewma_alpha: float = 0.5           # weight of the newest peak occ.
    high_water: float = 0.85          # grow when ewma > hw·capacity
    low_water: float = 0.5            # shrink when ewma < lw·cap(lower)
    calm_epochs: int = 3              # calm streak before de-actuation
    spill_hi: float = 0.01            # spill rate that forces "mass"
    gini_hi: float = 0.25             # imbalance that forces "mass"
    gini_lo: float = 0.10             # balance that counts as calm
    rebuild_patience: int = 3         # bad-gini epochs in mass -> rebuild


class ControllerState(NamedTuple):
    """The per-epoch carry: actuators (``slack_idx`` into the ladder,
    ``split``, ``force_rebuild``), the EWMA, the hysteresis counters,
    the last epoch's statistics and lifetime actuation counts."""
    slack_idx: int                    # index into cfg.slack_ladder
    split: str = "lanes"              # refresh boundary rule for next ep
    force_rebuild: bool = False       # one-shot full-rebuild request
    ewma: float = -1.0                # EWMA of peak occupancy (-1 unset)
    calm: int = 0                     # consecutive calm epochs
    backoff: int = 1                  # calm streak needed to de-escalate
    mass_bad: int = 0                 # bad-gini epochs while in "mass"
    retraces: int = 0                 # slack rung changes
    escalations: int = 0              # lanes->mass transitions
    last_spill: int = 0
    last_share: float = 0.0
    last_gini: float = 0.0

    def slack_of(self, cfg: ControllerConfig) -> float:
        """The ``route_slack`` this state's rung selects."""
        return cfg.slack_ladder[self.slack_idx]


def init_controller(n_shards: int, **overrides
                    ) -> Tuple[ControllerConfig, ControllerState]:
    """The default config for an ``n_shards``-way split and the initial
    state: the rung nearest ``DEFAULT_ROUTE_SLACK``, equal-lane refresh,
    estimator unset.  ``overrides`` replace config fields."""
    ladder = overrides.pop("slack_ladder", None) or \
        default_slack_ladder(n_shards)
    cfg = ControllerConfig(slack_ladder=tuple(ladder), **overrides)
    start = min(range(len(cfg.slack_ladder)),
                key=lambda i: (abs(cfg.slack_ladder[i]
                                   - DEFAULT_ROUTE_SLACK), i))
    return cfg, ControllerState(slack_idx=start)


def controller_to_dict(cfg: ControllerConfig,
                       state: ControllerState) -> dict:
    """JSON-safe form of the whole controller (config and carry); it
    survives a ``json.dumps`` round trip bit for bit."""
    c = cfg._asdict()
    c["slack_ladder"] = [float(s) for s in cfg.slack_ladder]
    s = state._asdict()
    s["force_rebuild"] = bool(state.force_rebuild)
    return {"config": c, "state": s}


def controller_from_dict(d: dict
                         ) -> Tuple[ControllerConfig, ControllerState]:
    """Inverse of :func:`controller_to_dict`."""
    c = dict(d["config"])
    c["slack_ladder"] = tuple(float(s) for s in c["slack_ladder"])
    return ControllerConfig(**c), ControllerState(**d["state"])


# ---------------------------------------------------------------------------
# the control law
# ---------------------------------------------------------------------------

def controller_step(cfg: ControllerConfig, state: ControllerState,
                    spill: int, occupancy, nq: int) -> ControllerState:
    """One epoch of the control law: fold ``(spill, occupancy)`` into
    the estimator and emit the next epoch's actuators.  A
    single-pseudo-shard occupancy (the meshless ``[1]`` vector) only
    records the statistics."""
    occ = np.asarray(occupancy)
    spill = int(spill)
    share = max_share(occ)
    gini = routing_gini(occ)
    if occ.size <= 1:                 # meshless: observe, never actuate
        return state._replace(force_rebuild=False, last_spill=spill,
                              last_share=share, last_gini=gini)

    n_shards = int(occ.size)
    peak = float(occ.max())
    a = cfg.ewma_alpha
    ewma = peak if state.ewma < 0 else a * peak + (1 - a) * state.ewma
    spill_rate = spill / max(nq, 1)
    idx = state.slack_idx
    split = state.split
    backoff = state.backoff
    retraces = state.retraces
    escalations = state.escalations
    capacity = route_capacity(nq, n_shards, cfg.slack_ladder[idx])

    calm_now = (spill == 0 and gini <= cfg.gini_lo
                and ewma <= cfg.high_water * capacity)
    calm = state.calm + 1 if calm_now else 0

    # (b) escalation: spill or imbalance past threshold -> mass re-split
    force_rebuild = False
    mass_bad = state.mass_bad
    if spill_rate > cfg.spill_hi or gini > cfg.gini_hi:
        if split == "lanes":
            split = "mass"
            escalations += 1
            mass_bad = 0
        elif gini > cfg.gini_hi:
            # mass is on and the boundaries still do not balance: after
            # rebuild_patience such epochs, ask for a full rebuild
            mass_bad += 1
            if mass_bad >= cfg.rebuild_patience:
                force_rebuild = True
                mass_bad = 0
    else:
        mass_bad = 0
        # (c) de-escalation after a calm streak; the next one needs
        # twice the streak
        if split == "mass" and calm >= max(cfg.calm_epochs, backoff):
            split = "lanes"
            backoff *= 2
            calm = 0

    # (a) slack ladder: grow on pressure, shrink only deep inside the
    # band (low_water of the lower rung's capacity)
    if spill > 0 or ewma > cfg.high_water * capacity:
        if idx < len(cfg.slack_ladder) - 1:
            idx += 1
            retraces += 1
            calm = 0
    elif (idx > 0 and calm >= cfg.calm_epochs and spill == 0
          and ewma < cfg.low_water * route_capacity(
              nq, n_shards, cfg.slack_ladder[idx - 1])):
        idx -= 1
        retraces += 1
        calm = 0

    return ControllerState(
        slack_idx=idx, split=split, force_rebuild=force_rebuild,
        ewma=ewma, calm=calm, backoff=backoff, mass_bad=mass_bad,
        retraces=retraces, escalations=escalations, last_spill=spill,
        last_share=share, last_gini=gini)


# ---------------------------------------------------------------------------
# the controlled serving loop
# ---------------------------------------------------------------------------

def run_serving_controlled(st, plane, kinds, keys, upd_mask,
                           aggregate: bool = False, max_new: int = None,
                           mesh=None, axis: str = "model",
                           plane_search: bool = False,
                           cfg: ControllerConfig = None,
                           state: ControllerState = None):
    """``splaylist.run_serving`` stepped from the host one epoch at a
    time, so the controller can pick each epoch's ``route_slack``,
    ``split`` and rebuild (its one-shot ``force_rebuild`` OR-ed into the
    overflow machine's pending flag).  The actuators change where
    queries are answered, never what they answer.

    With a ``mesh`` whose axis divides the plane's width (every rank of
    it runs this loop on the same replicated state and batches) each
    epoch runs sharded and the controller acts on its ``[S]``
    occupancy; otherwise it only observes, and the loop is the
    replicated ``run_serving``.  Returns ``(st, plane, results[E, B],
    path_len[E, B], overflow[E], spill[E], occupancy[E, S], states)``:
    the first seven as ``run_serving`` returns them, plus the
    :class:`ControllerState` after each epoch."""
    from repro_torch.core import splaylist as sx
    from repro_torch.parallel import sharding as shd

    dev = st.device
    kinds = sx._op_tensor(kinds, torch.int32, dev)
    keys = sx._op_tensor(keys, torch.int32, dev)
    upd_mask = sx._op_tensor(upd_mask, torch.bool, dev)
    E, B = keys.shape
    width = shd.plane_width(plane)
    sharded = sx._sharded(plane, mesh, axis)
    n_shards = int(mesh.shape[axis]) if sharded else 1
    if cfg is None:
        cfg, st0 = init_controller(n_shards)
        state = state if state is not None else st0
    elif state is None:
        _, state = init_controller(n_shards, slack_ladder=cfg.slack_ladder)
        state = state._replace(slack_idx=min(state.slack_idx,
                                             len(cfg.slack_ladder) - 1))

    outs, states = [], []
    pending = pressed = False
    for e in range(E):
        out = sx.run_epoch(
            st, plane, kinds[e], keys[e], upd_mask[e],
            aggregate=aggregate, max_new=max_new,
            rebuild=bool(pending or state.force_rebuild), mesh=mesh,
            axis=axis, plane_search=plane_search,
            split=state.split if sharded else "lanes",
            route_slack=state.slack_of(cfg) if sharded else None)
        st, plane, r, p, ov, sp, oc = out
        outs.append((r, p, ov, sp, oc))
        pending, pressed = overflow_machine_step(
            int(ov), int(st.size), B, width, pressed)
        state = controller_step(cfg, state, int(sp), oc.cpu().numpy(), B)
        states.append(state)
    res, plen, ovf, spl, occ = (torch.stack(x) for x in zip(*outs))
    return st, plane, res, plen, ovf, spl, occ, states

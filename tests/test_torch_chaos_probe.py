"""PyTorch port, the chaos probe: ``repro_torch.benchmarks.chaos_probe``
on a gloo world of 4 CPU ranks against the reference's
``benchmarks/chaos_probe.py`` on a host mesh of 4 devices.

The battery's counts and flags (per-family injected and detected
faults, wrong verdicts, recovery epochs, the pools' fault, audit,
repair, degradation and remesh counters, the crash's op and pending
ops, each restore's flag) are compared with tolerance 0, key for key;
only ``wall_s`` is dropped.  The port's ``main`` holds its four
assertions (detected == injected, no wrong verdict, recovery within
the bound, restores and replay exact).

The JAX side runs the reference's own functions under
``--xla_force_host_platform_device_count=4`` with ``jax.make_mesh``
building Auto-axes meshes in that process only.  In one process the
battery takes about 160 s on the CPU, so it runs in three (this file's
``__main__``): ``parts`` computes ``audit_battery``, ``crash_replay``
and ``restore_matrix``; ``mesh4`` runs ``chaos_serving`` as far as its
second ``_replay_chaos`` (the 1 x 4 pool under shard loss, 70 s of it)
and publishes that; ``battery`` runs the reference's ``run_battery``,
whose three parts and second replay read the others' results while its
first replay (the meshless pool) and the host-oracle rung run here."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

import mesh_cases as mc
from repro_torch.benchmarks import chaos_probe as tcp

ROOT = Path(__file__).resolve().parents[1]
PARTS = ("audit_battery", "crash_replay", "restore_matrix")


class _Published(Exception):
    """Ends the ``mesh4`` role once its replay is published."""


def jax_side(role: str, out_dir: str) -> None:
    sys.path.insert(0, str(ROOT))
    mc.auto_axes_make_mesh()
    from benchmarks import chaos_probe as chp

    def at(name):
        return os.path.join(out_dir, f"{name}.pkl")

    if role == "parts":
        for name in PARTS:
            mc.write_pickle(at(name), getattr(chp, name)())
        return
    replay, calls = chp._replay_chaos, []

    def second_replay(*args):
        calls.append(len(calls))
        if role == "mesh4" and len(calls) == 1:
            return None                  # the meshless replay: skipped
        if role == "mesh4":
            mc.write_pickle(at("mesh4"), replay(*args))
            raise _Published
        return replay(*args) if len(calls) == 1 else mc.wait_pickle(
            at("mesh4"))

    chp._replay_chaos = second_replay
    if role == "mesh4":
        try:
            chp.chaos_serving()
        except _Published:
            return
        raise RuntimeError("chaos_serving made no second replay")
    for name in PARTS:
        setattr(chp, name, lambda name=name: mc.wait_pickle(at(name)))
    mc.write_pickle(at("battery"), chp.run_battery())


@pytest.fixture(scope="module")
def battery(tmp_path_factory):
    from repro_torch.launch import spmd
    tmp = tmp_path_factory.mktemp("chaos")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT)]))
    procs = [subprocess.Popen([sys.executable, __file__, role, str(tmp)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for role in ("parts", "mesh4", "battery")]
    try:
        snaps = tmp / "snapshots"
        snaps.mkdir()
        port = spmd.spawn(tcp.run_battery, 4, str(snaps), device="cpu",
                          threads=1, timeout=600)
        for proc in procs:
            log, _ = proc.communicate(timeout=900)
            assert proc.returncode == 0, log
        with open(tmp / "battery.pkl", "rb") as f:
            ref = pickle.load(f)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return ref, port


def _det(d: dict) -> dict:
    return {k: v for k, v in d.items() if k != "wall_s"}


TOP = ("backends", "shards", "fault_families", "injected", "detected",
       "detection_within_epochs", "wrong_verdicts", "recovery_bound_epochs",
       "recovery_epochs_max", "restore_bit_identical",
       "replay_exactly_once", "audit_matrix", "chaos", "crash", "restores")


@pytest.mark.parametrize("key", TOP)
def test_battery_matches_reference(battery, key):
    """Rank 0's battery, entry by entry, against the reference's."""
    ref, port = battery
    assert sorted(_det(port[0])) == sorted(_det(ref)) == sorted(TOP)
    assert port[0][key] == ref[key], (key, port[0][key], ref[key])


def test_battery_agrees_across_ranks(battery):
    """Every rank of the 4-rank world reaches the same counts, the
    mesh pool's included (the ranks a shard loss leaves out serve
    meshless, with the same verdicts)."""
    _, port = battery
    for r, rank in enumerate(port[1:], 1):
        assert _det(rank) == _det(port[0]), r


def test_battery_passes_its_gates(battery):
    """The four assertions of the probe's ``main`` hold on rank 0's
    dict, and the battery exercised what it claims: faults in every
    bit-flip family, a masked rung on both pools, two remeshes."""
    _, port = battery
    out = port[0]
    tcp.check(out)
    assert out["injected"] > 0 and out["wrong_verdicts"] == 0
    fam = out["audit_matrix"]["families"]
    assert all(v["injected"] > 0 for v in fam.values())
    assert out["chaos"]["mesh4"]["remeshes"] == 2
    assert all(out["restores"].values())


def test_check_refuses_a_failed_battery(battery):
    """``check`` raises on each of the four gates."""
    _, port = battery
    for bad in ({"detected": port[0]["detected"] - 1},
                {"wrong_verdicts": 1},
                {"recovery_epochs_max": tcp.RECOVERY_BOUND + 1},
                {"replay_exactly_once": False}):
        with pytest.raises(AssertionError):
            tcp.check(dict(port[0], **bad))


if __name__ == "__main__":
    jax_side(sys.argv[1], sys.argv[2])

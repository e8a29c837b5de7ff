"""The comparison that decides ``correct``, driven through whole runs on
the CPU at small sizes: sound runs pass; each cell's control (the
reference with one guarantee broken) and each fault planted under the
timed path fail."""

import pytest
import torch

from repro_torch.core import splaylist as sx
from splaybench import control, harness
from splaybench.tests.small import READ, RW, control_sizes, sizes


def _run(workload, seed=7, make_system=harness.PortSystem, seconds=0.2,
         at=sizes, replayed=None):
    # the second value lists JAX modules the process holds; a test
    # process may hold them from other test files, so it is not read here
    s = at(workload)
    if replayed is not None:
        s["traffic"].update(check_batches=replayed, trace_from=0)
    out, _ = harness.run_cell(workload, seed, seconds, False,
                              device="cpu", make_system=make_system,
                              sizes=s)
    return out


def _failing(out):
    return {k for k, v in out["checks"].items() if v["value"] > v["limit"]}


@pytest.mark.parametrize("workload", [READ, RW])
@pytest.mark.parametrize("replayed,seconds", [(None, 0.2), (1, 0.7)])
def test_sound_run_is_correct(workload, replayed, seconds):
    out = _run(workload, seed=2 ** 33 + 5, seconds=seconds,
               replayed=replayed)
    if replayed:
        # batches past the replayed one ran and were checked
        assert out["attempted"] > replayed * 64
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert all(v["limit"] == 0 for v in out["checks"].values())


@pytest.mark.parametrize("workload,broken", [
    (READ, "state_diff"), (RW, "answer_diff")])
def test_control_is_not_correct(workload, broken):
    def make(cfg, traffic, device):
        return control.control_for(traffic)(cfg, traffic, device)
    out = _run(workload, make_system=make, at=control_sizes)
    assert not out["correct"]
    assert broken in _failing(out)


def _unchanged(real):
    def run(st, plane, *a, **k):
        out = real(st, plane, *a, **k)
        return (st, plane) + tuple(out[2:])
    return run


def _half_batch(real):
    def run(st, plane, kinds, keys, upd, **k):
        h = keys.shape[1] // 2
        out = real(st, plane, kinds[:, :h], keys[:, :h], upd[:, :h], **k)
        pad = torch.zeros_like(keys[:, h:], dtype=out[2].dtype)
        res = torch.cat([out[2], pad], 1)
        plen = torch.cat([out[3], pad.to(out[3].dtype)], 1)
        return out[:2] + (res, plen) + tuple(out[4:])
    return run


def _altered(real):
    """One answer a batch flipped: a write's where the batch has one (the
    check holds every write), else the first read's."""
    def run(st, plane, kinds, keys, upd, **k):
        out = real(st, plane, kinds, keys, upd, **k)
        res = out[2].clone()
        writes = torch.nonzero(kinds[0] != sx.OP_CONTAINS)
        j = int(writes[0, 0]) if writes.numel() else 0
        res[0, j] ^= 1
        return out[:2] + (res,) + tuple(out[3:])
    return run


@pytest.mark.parametrize("workload", [READ, RW])
@pytest.mark.parametrize("fault,caught", [
    (_unchanged, "state_diff"), (_half_batch, "answer_diff"),
    (_altered, "answer_diff")])
def test_fault_under_the_timed_path_is_not_correct(monkeypatch, workload,
                                                   fault, caught):
    monkeypatch.setattr(sx, "run_serving", fault(sx.run_serving))
    out = _run(workload)
    assert not out["correct"]
    assert caught in _failing(out)


def _from_call(n, fault):
    """``fault`` applied from the ``n``-th call of ``run_serving`` on."""
    def wrap(real):
        broken, calls = fault(real), [0]

        def run(*a, **k):
            calls[0] += 1
            return (broken if calls[0] > n else real)(*a, **k)
        return run
    return wrap


def _stale_plane(real):
    def run(st, plane, *a, **k):
        out = real(st, plane, *a, **k)
        return (out[0], plane) + tuple(out[2:])
    return run


@pytest.mark.parametrize("workload,fault,caught", [
    (READ, _altered, "answer_diff"), (RW, _altered, "answer_diff"),
    (READ, _stale_plane, "final_plane_diff"),
    (RW, _stale_plane, "final_plane_diff"),
    (RW, _unchanged, "member_diff")])
def test_fault_past_the_replayed_batches_is_not_correct(
        monkeypatch, workload, fault, caught):
    """A fault that starts after the batches the reference replays (one
    warm-up batch and one replayed) is still seen, with every later
    batch's answers checked."""
    monkeypatch.setattr(harness, "SAMPLE_EVERY", 1)
    monkeypatch.setattr(sx, "run_serving",
                        _from_call(2, fault)(sx.run_serving))
    out = _run(workload, at=control_sizes, seconds=0.7, replayed=1)
    assert not out["correct"]
    assert caught in _failing(out)
    assert out["checks"]["state_diff"]["value"] == 0

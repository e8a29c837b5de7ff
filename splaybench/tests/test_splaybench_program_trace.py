"""The readers of the program's own spans and counters on hand-made
traces: device time by span through the in-order pairing, idle time
inside the serving call, the counters' arithmetic, nothing read from a
program without them, and the device-trace readers unmoved by the
program's ranges.  A small traced run on the CPU reports the counters'
metrics."""

import importlib.util
from types import SimpleNamespace

import pytest

from splaybench import harness, program_trace
from splaybench.tests import small
from splaybench.yardstick import TraceSummary

METRICS = harness.BENCH_DIR / "metrics"
NEW = ("fold_steps_per_walk", "fold_ns_per_step", "refresh_dev_ms",
       "fold_list_dev_ms", "program_idle_ms", "waits_per_batch")
DEVICE_TRACE = ("search_dev_ms", "walk_dev_ms", "fold_dev_ms",
                "torch_dev_ms", "idle_share", "syncs_per_batch",
                "search_roofline_pct", "walk_roofline_pct",
                "fold_roofline_pct")


@pytest.fixture(autouse=True)
def _tracing_off_after():
    yield
    from repro_torch.core import trace
    trace.enable(False)
    trace.reset_counts()


def _module(name):
    spec = importlib.util.spec_from_file_location(
        f"test_metric_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Counts:
    """A stand-in for the program's trace module."""

    def __init__(self, c):
        self.c = c

    def counts(self, profiled=False):
        assert profiled
        return dict(self.c)


def _summary(batches=2):
    """Two batches: each a serving call that enqueues the walk, the fold
    list's sort, F and the refresh's scan; the harness's draw before it
    and its answer copy after."""
    host, dev = [("bench.window", 0, 200)], []
    for b, t in enumerate((0, 100)):
        host += [("bench.serve", t + 5, t + 95),
                 ("cudaLaunchKernel", t + 2, t + 3),          # the draw
                 ("splay.serving", t + 6, t + 90),
                 ("splay.epoch", t + 7, t + 80),
                 ("splay.walk", t + 8, t + 12),
                 ("cudaLaunchKernel", t + 9, t + 10),
                 ("cudaStreamSynchronize", t + 10, t + 12),
                 ("splay.fold_list", t + 13, t + 16),
                 ("cudaLaunchKernel", t + 14, t + 15),
                 ("splay.fold", t + 17, t + 20),
                 ("cudaLaunchKernel", t + 18, t + 19),
                 ("splay.refresh", t + 21, t + 30),
                 ("cudaLaunchKernel", t + 22, t + 23),
                 ("cudaMemcpyAsync", t + 91, t + 92)]           # answers
        dev += [("elementwise", t + 3, t + 4),
                ("walk_kernel", t + 10, t + 11),
                ("DeviceRadixSortOnesweepKernel", t + 15, t + 17),
                ("fold_kernel<int>", t + 19, t + 60),
                ("scan_innermost_dim", t + 60, t + 62),
                ("Memcpy DtoH", t + 92, t + 93)]
    return TraceSummary(dev, host, 0, 200, batches)


def test_device_time_by_span_pairs_enqueues_in_order():
    by = program_trace.device_by_span(_summary())
    assert by["splay.walk"] == pytest.approx(2e-6)
    assert by["splay.fold_list"] == pytest.approx(4e-6)
    assert by["splay.fold"] == pytest.approx(82e-6)
    assert by["splay.refresh"] == pytest.approx(4e-6)
    # the harness's draw and answer copy sit outside every span
    assert by[program_trace.NO_SPAN] == pytest.approx(4e-6)
    # the device's clock a little behind the host's: the draw's activity
    # starts before the slice does; a first call whose activity the
    # session missed
    s = _summary()
    s.device[0] = ("elementwise", -2, -1)
    s.host.append(("cudaLaunchKernel", -9, -8))
    assert program_trace.device_by_span(s) == by
    # a copy the trace lost: the pairs realign at it
    s = _summary()
    s.device.remove(("Memcpy DtoH", 92, 93))
    lost = program_trace.device_by_span(s)
    assert lost[program_trace.NO_SPAN] == pytest.approx(3e-6)
    assert {k: v for k, v in lost.items() if k != program_trace.NO_SPAN} \
        == {k: v for k, v in by.items() if k != program_trace.NO_SPAN}
    # a kernel's call lost among kernels: the pairs before it shift back
    # to the last change of kind (the draw's activity is left out)
    s = _summary()
    s.host.remove(("cudaLaunchKernel", 9, 10))
    lost = program_trace.device_by_span(s)
    assert lost["splay.walk"] == pytest.approx(1e-6)
    assert lost[program_trace.NO_SPAN] == pytest.approx(4e-6)
    assert lost["splay.fold"] == pytest.approx(82e-6)
    parent = TraceSummary([("fold_kernel", 19, 60)],
                          [("bench.window", 0, 99),
                           ("cudaLaunchKernel", 18, 19)], 0, 99, 1)
    assert program_trace.device_by_span(parent) is None


def test_idle_inside_the_serving_call():
    s = _summary()
    # each call's activities reach from 10 to 62 (walk to the refresh's
    # scan), busy 10-11, 15-17, 19-62: 6 us idle
    assert program_trace.idle_inside_s(s, "splay.serving") == \
        pytest.approx(2 * 6e-6)
    # the device's clock 3 us behind the host's: the same
    late = TraceSummary([(n, a + 3, b + 3) for n, a, b in s.device], s.host,
                        s.t0, s.t1, s.batches)
    assert program_trace.idle_inside_s(late, "splay.serving") == \
        pytest.approx(2 * 6e-6)
    assert program_trace.idle_inside_s(s, "splay.none") is None


def test_the_new_readers_on_a_synthetic_run():
    mods = {n: _module(n) for n in NEW}
    counts = {"fold.walks": 400, "fold.steps": 8000, "waits.walk.status": 2,
              "waits.serving.size": 2, "waits.refresh.new": 2,
              "epochs": 2}
    for n in ("fold_steps_per_walk", "fold_ns_per_step", "waits_per_batch"):
        mods[n].TRACE = _Counts(counts)
    ctx = {"summary": _summary(), "batches": 10}
    got = {n: m.read(ctx) for n, m in mods.items()}
    assert got["fold_steps_per_walk"] == 20.0
    # F: 2 x 41 us over 8000 steps
    assert got["fold_ns_per_step"] == pytest.approx(82e3 / 8000)
    assert got["refresh_dev_ms"] == pytest.approx(2e-3)
    assert got["fold_list_dev_ms"] == pytest.approx(2e-3)
    assert got["program_idle_ms"] == pytest.approx(6e-3)
    assert got["waits_per_batch"] == 3.0
    # an older program: no trace module, no span
    for n in ("fold_steps_per_walk", "fold_ns_per_step", "waits_per_batch"):
        mods[n].TRACE = None
    bare = _summary()
    bare.host = [e for e in bare.host if not e[0].startswith("splay.")]
    assert all(m.read(dict(ctx, summary=bare)) is None
               for m in mods.values())
    assert all(m.read(dict(ctx, summary=None)) is None
               for m in mods.values())


def _event(name, a, b, device, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=a, end=b),
                           is_user_annotation=annotation)


def _profile(with_program_ranges):
    from torch.autograd import DeviceType
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    s = _summary()
    evs = [_event(n, a, b, cpu, n.startswith(("bench.", "splay.")))
           for n, a, b in s.host
           if with_program_ranges or not n.startswith("splay.")]
    evs += [_event(n, a, b, cuda) for n, a, b in s.device]
    # the device timeline's copy of the harness's ranges
    evs += [_event("bench.serve", 9, 95, cuda, True)]
    if with_program_ranges:
        evs += [_event(n, a, b, cuda, True) for n, a, b in
                (("splay.serving", 10, 62), ("splay.fold", 19, 60),
                 ("splay.refresh", 60, 62))]
    return SimpleNamespace(events=lambda: evs)


def test_device_trace_readers_unmoved_by_the_program_ranges():
    ctx = {"work": {k: {"bytes": 1e6, "ops": 0}
                    for k in ("search", "walk", "fold")},
           "peak": {"hbm_bytes_per_s": 1e12, "int32_ops_per_s": 1e13}}
    read = {}
    for ranges in (False, True):
        s = TraceSummary.from_profile(_profile(ranges), 2)
        assert not [n for n, _, _ in s.device if n.startswith("splay.")]
        read[ranges] = {n: harness.load_reader(n)(dict(ctx, summary=s))
                        for n in DEVICE_TRACE}
    assert read[False] == read[True]
    assert read[True]["fold_dev_ms"] == pytest.approx(0.041)


@pytest.mark.parametrize("workload", [small.READ, small.RW])
def test_a_small_traced_run_reports_the_counters(workload):
    out, _ = harness.run_cell(workload, 2 ** 31 + 77, 0.5, True,
                              device="cpu", sizes=small.sizes(workload))
    assert out["correct"]
    m = out["metrics"]
    assert m["fold_steps_per_walk"]["value"] > 1
    assert m["waits_per_batch"]["value"] >= 9
    # no device on the CPU: the device and span readers find nothing
    assert not {"fold_ns_per_step", "refresh_dev_ms", "program_idle_ms",
                "fold_list_dev_ms"} & set(m)
    from repro_torch.core import trace
    assert trace.enabled()
    assert trace.counts(profiled=True)["epochs"] >= 1

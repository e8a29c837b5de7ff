"""The yardstick on hand-made shapes: the work counts of each kernel,
the trace's reduction, and the readers' arithmetic."""

import numpy as np
import pytest

from splaybench import reference, yardstick
from splaybench.yardstick import TraceSummary


def test_descent_work_on_a_four_key_plane():
    # rows: [40] / [20, 40] / [10, 20, 30, 40]
    plane = reference.plane([10, 20, 30, 40], [0, 1, 0, 2], 3, 4)
    assert plane["keys"].tolist() == [
        [40, reference.PAD_KEY, reference.PAD_KEY, reference.PAD_KEY],
        [20, 40, reference.PAD_KEY, reference.PAD_KEY], [10, 20, 30, 40]]
    assert plane["rank_map"].tolist() == [[1, 2, 2, 2], [1, 3, 4, 4],
                                          [0, 1, 2, 3]]
    # query 20: windows [-1, 1], [-1, 1], [1, 3]: 2 + 2 + 3 entries, two
    # candidates each
    w = yardstick.descent_work(plane, [20])
    assert w == {"bytes": 13 + 4 * 3 + 4 * 2 * 7, "ops": 6}


def test_walk_work_counts_distinct_reads_once():
    ref = reference.SplayList(3)             # empty: head -> tail
    one = yardstick.walk_work(ref, [7])
    assert one == {"bytes": 12 + 4 * (1 + 2 + 1 + 1), "ops": 0}
    two = yardstick.walk_work(ref, [7, 7])
    assert two["bytes"] == one["bytes"] + 12


def test_fold_work_and_the_journal():
    assert yardstick.fold_work(10, 12, 100) == {"bytes": 320, "ops": 0}
    ref, _, _ = reference.populate(8, np.arange(20))
    ref.start_journal()
    assert ref.stop_journal() == 0
    ref.start_journal()
    ref.fold_batch(np.array([3, 3, 4]), np.array([True, True, False]))
    changed = ref.stop_journal()
    # m, the key's selfhits, and at least one parent's counter
    assert changed >= 4 * 3


def test_least_time_takes_the_larger_bound():
    peak = {"hbm_bytes_per_s": 1e12, "int32_ops_per_s": 1e13}
    assert yardstick.least_s({"bytes": 1e9, "ops": 1e9}, peak) == 1e-3
    assert yardstick.least_s({"bytes": 1e6, "ops": 1e11}, peak) == 1e-2
    assert yardstick.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] \
        == 3.35e12
    assert yardstick.peaks("no such card") is None


def _summary():
    dev = [("void (anonymous namespace)::fold_kernel<int>(...)", 10, 40),
           ("descent_kernel(int const*)", 45, 50),
           ("Memcpy DtoH", 48, 60), ("walk_kernel", 80, 90)]
    host = [("bench.window", 0, 100), ("bench.serve", 5, 95),
            ("aten::sort", 60, 78), ("cudaStreamSynchronize", 62, 70),
            ("cudaStreamSynchronize", 96, 99)]
    return TraceSummary(dev, host, 0, 100, 2)


def test_trace_reduction():
    s = _summary()
    assert s.window_s == pytest.approx(1e-4)
    assert s.busy_s() == pytest.approx(55e-6)       # 10-40, 45-60, 80-90
    assert s.kernel_s("fold") == pytest.approx(30e-6)
    assert s.kernel_s("torch") == pytest.approx(12e-6)
    assert s.syncs_in("bench.serve") == 1
    b = s.breakdown()
    assert b["device_ops"][0] == [dev_name(s, "fold"), pytest.approx(3e-5)]
    # gaps 0-10, 40-45, 60-80, 90-100, named by the innermost host event
    # at their middles: 70 lies in a sync inside aten::sort, the rest
    # under the serving call
    assert b["idle_gaps"] == [["bench.serve", pytest.approx(2.5e-5)],
                              ["cudaStreamSynchronize", pytest.approx(2e-5)]]
    assert yardstick.idle_gaps([(1, 2), (2, 5)], 0, 6) == [(0, 1), (5, 6)]
    assert yardstick.union_s([(0, 2), (1, 3), (5, 6)]) == pytest.approx(
        4e-6)


def dev_name(s, layer):
    return next(n for n, _, _ in s.device if yardstick.layer_of(n) == layer)


def test_readers_arithmetic():
    s = _summary()
    ctx = {"summary": s, "work": {"fold": {"bytes": 3.0e4, "ops": 0}},
           "peak": {"hbm_bytes_per_s": 1e12, "int32_ops_per_s": 1e13}}
    assert yardstick.dev_ms(ctx, "fold") == pytest.approx(0.015)
    # least 3e-8 s a batch over 1.5e-5 s a batch
    assert yardstick.roofline_pct(ctx, "fold") == pytest.approx(0.2)
    assert yardstick.roofline_pct(ctx, "walk") is None   # no count
    assert yardstick.dev_ms(dict(ctx, summary=None), "fold") is None

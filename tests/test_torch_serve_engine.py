"""PyTorch port, the serving engine: ``repro_torch.serve.engine`` against
the JAX package's ``Engine`` on the CPU, on the same arrivals
(``poisson_zipf_arrivals``, equal for equal seeds in both packages),
from the same float32 smoke parameters (``zoo.build_params(cfg,
PRNGKey(0))`` converted array by array), with the host and the device
session index: generated ids, latencies, stalls, preemptions, retries
under a ``FaultPlan``, the pool's chains and the vocab cache's counters
all equal.  Then the reference engine's own behaviours on the port
alone (arrival order, truncation, preemption, backpressure, the vocab
tap, idle jumps, fault retries), and the entry point
``launch/serve.main``."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import registry
from repro.core import faults as fl
from repro.core import workload as wl
from repro.launch import serve as jserve
from repro.models import model_zoo as zoo
from repro.serve.engine import Engine, Request
from repro_torch.configs import registry as treg
from repro_torch.core import convert
from repro_torch.core import faults as tfl
from repro_torch.core import workload as twl
from repro_torch.launch import serve as tserve
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import Request as TRequest

ARCH = "qwen2-0.5b"


@pytest.fixture(scope="module")
def smoke():
    cfg = registry.get_smoke(ARCH)
    params, _ = zoo.build_params(cfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                   device="cpu")
    return cfg, params, treg.get_smoke(ARCH), tp


def _engines(smoke, fault=None, jax_too=True, **kw):
    """The JAX and the port engine with the same arguments (the port's
    on the CPU); ``jax_too=False`` builds the port's alone."""
    cfg, params, tcfg, tp = smoke
    args = dict(max_batch=2, max_seq=48, n_pages=64, page_size=4,
                use_splay_tier=True, stream_epochs=2)
    args.update(kw)
    targs = dict(args)
    if fault is not None:
        args["fault_plan"] = fl.FaultPlan(
            seed=1, events=[fl.FaultEvent(*e) for e in fault])
        targs["fault_plan"] = tfl.FaultPlan(
            seed=1, events=[tfl.FaultEvent(*e) for e in fault])
    te = TEngine(tcfg, tp, device="cpu", **targs)
    return (Engine(cfg, params, **args) if jax_too else None), te


def _port(smoke, **kw):
    return _engines(smoke, jax_too=False, **kw)[1]


def _submit(eng, arr, req=Request):
    for i in range(len(arr.seq_ids)):
        L = int(arr.prompt_lens[i])
        eng.submit(req(seq_id=int(arr.seq_ids[i]),
                       prompt=arr.prompts[i, :L].copy(),
                       max_new=int(arr.max_new[i]),
                       arrival=int(arr.arrival[i])))


def _summary(eng, results):
    out = dict(results=results, latencies=eng.latencies, clock=eng.clock,
               stalls=eng.stalls, preemptions=eng.preemptions,
               retries=eng.degraded_retries, tokens_out=eng.tokens_out,
               chains=dict(eng.pool.chains), free=sorted(eng.pool.free),
               util=eng.pool.utilization)
    vc = eng.vocab_cache
    out.update(vc_m=vc.m, vc_epochs=vc.stream_epochs,
               vc_counts=np.asarray(vc.counts).tolist(),
               vc_hot=np.asarray(vc.hot_ids).tolist())
    if eng.pool.device:
        out["pool_stats"] = dict(eng.pool.stats)
    return out


# ---------------------------------------------------------------------------
# arrivals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n_requests=32, rate=0.5, vocab=512, seed=3),
    dict(n_requests=8, rate=float("inf"), vocab=256000, prompt_len=(2, 7),
         max_new=8, seed=0),
    dict(n_requests=5, rate=2.0, vocab=64, prompt_len=4, max_new=(1, 9),
         zipf_s=1.3, seed=11),
    dict(n_requests=0, rate=1.0, vocab=16, seed=2)])
def test_arrivals_equal_jax(kw):
    a, b = wl.poisson_zipf_arrivals(**kw), twl.poisson_zipf_arrivals(**kw)
    assert a.name == b.name
    for f in ("arrival", "seq_ids", "prompts", "prompt_lens", "max_new"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    r, p = b.prompts.shape
    assert (np.diff(b.arrival) >= 0).all() and len(set(b.seq_ids)) == r
    live = np.arange(p)[None, :] < b.prompt_lens[:, None]
    assert ((b.prompts >= 1) & (b.prompts < kw["vocab"]))[live].all()
    assert (b.prompts[~live] == -1).all() and (b.max_new >= 1).all()


@pytest.mark.parametrize("kw", [dict(n_requests=-1), dict(rate=0.0),
                                dict(vocab=1), dict(prompt_len=0),
                                dict(max_new=(0, 3))])
def test_arrivals_refuse_what_jax_refuses(kw):
    args = dict(n_requests=4, rate=1.0, vocab=64)
    args.update(kw)
    with pytest.raises(ValueError):
        wl.poisson_zipf_arrivals(**args)
    with pytest.raises(ValueError):
        twl.poisson_zipf_arrivals(**args)


# ---------------------------------------------------------------------------
# the two engines on the same arrivals
# ---------------------------------------------------------------------------

CASES = {
    # one burst, a tight pool: stalls and preemptions
    "burst_tight_pool": (dict(n_requests=6, rate=float("inf"), vocab=64,
                              prompt_len=(3, 6), max_new=6, seed=4),
                         dict(n_pages=7, max_batch=3), None),
    # Poisson arrivals: idle jumps, waves of one and two
    "poisson": (dict(n_requests=6, rate=0.4, vocab=512, prompt_len=(2, 5),
                     max_new=(2, 5), seed=9), {}, None),
    # a crash injected at lookup epoch 1: the wave retries
    "crash_retry": (dict(n_requests=3, rate=float("inf"), vocab=64,
                         prompt_len=(2, 4), max_new=3, seed=5),
                    dict(max_batch=3, index_width=16, index_batch=4),
                    [(1, fl.FAULT_CRASH)]),
}


@pytest.mark.parametrize("case,device_index", [
    (c, d) for c in CASES for d in (False, True)
    if d or CASES[c][2] is None])      # faults hit the device index only
def test_engine_matches_jax(smoke, case, device_index):
    arr_kw, kw, fault = CASES[case]
    arr = wl.poisson_zipf_arrivals(**arr_kw)
    je, te = _engines(smoke, fault=fault, device_index=device_index, **kw)
    _submit(je, arr)
    _submit(te, twl.poisson_zipf_arrivals(**arr_kw), TRequest)
    want = _summary(je, je.run())
    got = _summary(te, te.run())
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    if case == "burst_tight_pool":
        assert want["stalls"] + want["preemptions"] > 0
    if case == "crash_retry":
        assert want["retries"] == 1 and te._consec_fail == 0


def test_host_and_device_index_engines_agree(smoke):
    """The reference's own contract on the port: a host-indexed and a
    device-indexed engine given the same arrivals agree on everything
    they emit."""
    arr_kw, kw, _ = CASES["burst_tight_pool"]
    out = []
    for device_index in (False, True):
        te = _port(smoke, device_index=device_index, **kw)
        _submit(te, twl.poisson_zipf_arrivals(**arr_kw), TRequest)
        s = _summary(te, te.run())
        s.pop("pool_stats", None)
        out.append(s)
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the reference engine's behaviours, on the port
# ---------------------------------------------------------------------------

def test_queue_drains_in_arrival_order(smoke):
    eng = _port(smoke, max_batch=1)
    rng = np.random.default_rng(0)
    for arrival, sid in [(30, 2), (0, 0), (10, 1)]:
        eng.submit(TRequest(seq_id=sid, prompt=rng.integers(1, 64, 3),
                            max_new=2, arrival=arrival))
    res = eng.run()
    assert list(res) == [0, 1, 2]
    assert all(v == 5 for v in eng.latencies.values()), eng.latencies
    assert eng.queue == [] and eng.clock >= 35


def test_per_request_max_new_truncation(smoke):
    eng = _port(smoke)
    rng = np.random.default_rng(2)
    eng.submit(TRequest(seq_id=0, prompt=rng.integers(1, 64, 3), max_new=2))
    eng.submit(TRequest(seq_id=1, prompt=rng.integers(1, 64, 3), max_new=6))
    res = eng.run()
    assert len(res[0]) == 2 and len(res[1]) == 6
    assert eng.latencies[0] < eng.latencies[1]
    assert eng.pool.utilization == 0.0


def test_page_exhaustion_preempts_and_requeues(smoke):
    arr = twl.poisson_zipf_arrivals(6, float("inf"), 64, prompt_len=(3, 6),
                                    max_new=6, seed=4)
    eng = _port(smoke, n_pages=7, max_batch=3)
    _submit(eng, arr, TRequest)
    res = eng.run()
    assert set(res) == set(range(6))
    assert all(len(v) == 6 for v in res.values())
    assert eng.stalls + eng.preemptions > 0
    assert eng.pool.utilization == 0.0
    assert sorted(eng.pool.free) == list(range(7))


def test_admission_never_overcommits_pool(smoke):
    eng = _port(smoke, n_pages=2, max_batch=4, page_size=4)
    rng = np.random.default_rng(5)
    for i in range(3):
        eng.submit(TRequest(seq_id=i, prompt=rng.integers(1, 64, 4),
                            max_new=2))
    assert set(eng.run()) == {0, 1, 2}
    assert eng.stalls > 0


def test_single_request_exceeding_pool_raises(smoke):
    eng = _port(smoke, n_pages=1, page_size=2)
    eng.submit(TRequest(seq_id=0, prompt=np.array([1, 2, 3]), max_new=2))
    with pytest.raises(RuntimeError, match="cannot be admitted"):
        eng.run()


def test_decode_stream_feeds_vocab_cache(smoke):
    eng = _port(smoke, stream_epochs=2)
    rng = np.random.default_rng(6)
    for i in range(2):
        eng.submit(TRequest(seq_id=i, prompt=rng.integers(1, 64, 3),
                            max_new=5))
    eng.run()
    vc = eng.vocab_cache
    assert vc.stream_epochs > 0
    assert vc.m == vc.counts.sum() > 0
    assert vc.m <= eng.tokens_out + len(eng.latencies)
    assert eng._stream_buf == []


def test_idle_clock_jumps_to_next_arrival(smoke):
    eng = _port(smoke)
    eng.submit(TRequest(seq_id=0, prompt=np.array([1, 2]), max_new=2,
                        arrival=100))
    assert set(eng.run()) == {0}
    assert eng.latencies[0] < 100 and eng.clock >= 100


def test_persistent_faults_surface_after_max_retries(smoke):
    te = _port(smoke, fault=[(e, tfl.FAULT_CRASH) for e in range(64)],
               device_index=True, index_width=16, index_batch=4,
               max_retries=3)
    te.submit(TRequest(seq_id=0, prompt=np.array([3, 4], np.int32),
                       max_new=2))
    with pytest.raises(tfl.InjectedCrash):
        te.run()
    assert te.degraded_retries == 4


def test_engine_refuses_a_mesh_and_foreign_params(smoke):
    _, _, tcfg, tp = smoke
    with pytest.raises(TypeError, match="Mesh"):
        TEngine(tcfg, tp, device="cpu", mesh=object())
    meta = {k: v.to("meta") for k, v in tp.items()}
    with pytest.raises(ValueError, match="params lie on"):
        TEngine(tcfg, meta, device="cpu")


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--device-index", "--audit-every",
                                        "1", "--rate", "0.5"]])
def test_serve_main_runs(extra, capsys):
    res = tserve.main(["--smoke", "--device", "cpu", "--requests", "3",
                       "--max-new", "2", *extra])
    assert set(res) == {0, 1, 2} and all(len(v) == 2 for v in res.values())
    out = capsys.readouterr().out
    assert "served 3 sequences" in out
    if extra:
        assert "audit OK" in out


@pytest.mark.parametrize("flag", [["--snapshot-dir"], ["--resume"]])
def test_serve_main_snapshot_flags_raise(flag, tmp_path, capsys):
    """The snapshot flags raised ``NotImplementedError`` until the port
    took over ``serve/snapshot.py``; now neither raises.
    ``--snapshot-dir`` publishes a snapshot after the run, and
    ``--resume`` without a snapshot directory starts afresh, as in the
    reference.  (The round trip through both flags is in
    ``tests/test_torch_checkpoint.py``.)"""
    args = ["--smoke", "--device", "cpu", "--requests", "2", "--max-new",
            "2", *flag]
    if flag == ["--snapshot-dir"]:
        args.append(str(tmp_path))
    res = tserve.main(args)
    assert set(res) == {0, 1}
    out = capsys.readouterr().out
    assert "restored" not in out
    assert ("saved serving snapshot" in out) == (flag == ["--snapshot-dir"])


def test_splay_demo_matches_jax(capsys):
    args = dict(seed=0, epochs=3, batch=64)
    want = jserve.splay_demo(type("A", (), args)())
    got = tserve.splay_demo(type("A", (), dict(args, device="cpu"))())
    for k in ("epochs", "batch", "hit_rate", "mean_path",
              "overflow_epochs", "alive", "audit"):
        assert got[k] == want[k], k
    assert "sharded serving skipped" in capsys.readouterr().out


def test_arrivals_drive_both_engines_at_full_vocab(smoke):
    """The arrivals ``launch/serve`` makes for minitron-8b (vocab 256000)
    are the JAX package's: the full-width run serves the same
    requests."""
    cfg = treg.get("minitron-8b")
    a = wl.poisson_zipf_arrivals(8, float("inf"), cfg.vocab,
                                 prompt_len=(2, 7), max_new=8, seed=0)
    b = twl.poisson_zipf_arrivals(8, float("inf"), cfg.vocab,
                                  prompt_len=(2, 7), max_new=8, seed=0)
    np.testing.assert_array_equal(a.prompts, b.prompts)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        registry.get("minitron-8b"))

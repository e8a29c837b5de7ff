"""Checks and readings shared by ``chip_smoke.py``, the profile scripts
(``scripts/train_step_profile.py``, ``scripts/engine_step_profile.py``)
and the CUDA-marked tests (``tests/test_torch_cuda.py``): the card's
name and power limit, the device's busy time in a ``torch.profiler``
trace, the H100's published rates and the bounds made from them, and
the comparisons of the card's float32 results with the CPU's
(``Agreement``, with the CPU's float64 run of the same code as the
witness of a miss: ``float64_mode``).  Imports torch only inside its
functions, and nothing of the port at import time.

A failed comparison raises ``CheckFailed`` (an ``AssertionError``)."""

from __future__ import annotations

import math
import subprocess

import numpy as np

MEM_BW = 3.35e12          # H100 SXM HBM3, bytes/s
BF16_OPS = 989e12         # H100 SXM dense bf16 tensor-core rate, FLOP/s


class CheckFailed(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def device_busy(prof, n_top=6):
    """The device activities of a ``torch.profiler`` trace (kernels,
    copies, memsets; an op's CPU event also carries its kernels' time
    and would count it twice): ``(activities, busy ms, span ms, top)``,
    busy the union of their intervals, top the ``n_top`` names that take
    the most time as ``(name, (count, us))``.  None if it has none."""
    from torch.autograd import DeviceType
    kev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kev)
    if not spans:
        return None
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        busy_us += max(b - max(a, end), 0.0)
        end = max(end, b)
    by_name = {}
    for e in kev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n_top]
    return kev, busy_us / 1e3, (end - spans[0][0]) / 1e3, top


def decode_bound_ms(params, batch: int) -> float:
    """The least time of one decode step: its weight reads (every
    parameter but the embedding table) and its ``batch`` embedding rows,
    over the card's memory rate."""
    weight_bytes = sum(v.numel() * v.element_size()
                       for k, v in params.items() if k != "embed")
    emb = params["embed"]
    return 1e3 * (weight_bytes + batch * emb.shape[1] * emb.element_size()
                  ) / MEM_BW


def float64_mode(torch):
    """A ``TorchFunctionMode`` under which each float32 that code asks
    for (``.float()``, ``.to(torch.float32)``, ``dtype=torch.float32``)
    is float64: the model's own code run in float64, the witness that
    ``Agreement`` holds two float32 results against."""
    from torch.overrides import TorchFunctionMode

    class Float64(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = dict(kwargs or {})
            if func is torch.Tensor.float:
                func = torch.Tensor.double
            if kwargs.get("dtype") is torch.float32:
                kwargs["dtype"] = torch.float64
            args = tuple(torch.float64 if a is torch.float32 else a
                         for a in args)
            return func(*args, **kwargs)
    return Float64()


def as_float64(tree):
    """The parameter tree or cache, its float tensors in float64."""
    return {k: (as_float64(v) if isinstance(v, dict)
                else v.double() if v.is_floating_point() else v)
            for k, v in tree.items()}


class Agreement:
    """The card's float32 result against the CPU's, ``allclose(rtol
    1e-4, atol 1e-5)``.  Where that misses and a float64 result of the
    same computation on the CPU is given (the witness), the card passes
    if its largest distance from the witness is at most twice the CPU's
    float32 result's: two float32 results of one ill-conditioned
    computation err by comparable amounts, a fault on the card by far
    more.  The witness may be a function that computes it, called only
    on a miss.  Keeps the largest difference and each witnessed
    case."""

    def __init__(self, torch, arch):
        self.torch, self.arch = torch, arch
        self.worst = 0.0
        self.witnessed = []

    def __call__(self, got, want, what, witness=None):
        torch = self.torch
        diff = float((got - want).abs().max())
        self.worst = max(self.worst, diff)
        if torch.allclose(got, want, rtol=1e-4, atol=1e-5):
            return
        check(witness is not None,
              f"{self.arch}: {what} on the card differs from the CPU's "
              f"(max {diff:.3e})")
        if callable(witness):
            witness = witness()
        e_card = float((got.double() - witness).abs().max())
        e_cpu = float((want.double() - witness).abs().max())
        self.witnessed.append((what, diff, e_card, e_cpu))
        check(e_card <= 2 * e_cpu,
              f"{self.arch}: {what} on the card differs from the CPU's "
              f"(max {diff:.3e}) and lies {e_card:.3e} from the float64 "
              f"result, more than twice the CPU's float32 {e_cpu:.3e}")


def stage_check(torch, zoo, cfg, p_dev, p_cpu, toks, fr, agree, p64=None):
    """``forward`` on the card against the CPU, stage by stage: each
    stage starts both from the CPU's state, and its output is read
    through the model's head (final norm and unembedding) on both sides;
    then the logits, and the untapped passes' greedy tokens.  With
    ``p64``, the same tapped pass also runs in float64 on the CPU as
    ``agree``'s witness."""
    dev = p_dev["embed"].device
    stages, wit = {}, {}

    def record(name, x):
        stages[name] = x
        return x

    t_cpu = torch.as_tensor(toks)
    f_cpu = None if fr is None else torch.as_tensor(fr)
    want = zoo.forward(p_cpu, cfg, t_cpu, frontend=f_cpu, tap=record)
    w_logits = None
    if p64 is not None:
        def record64(name, x):
            wit[name] = zoo.logits_out(p64, cfg, x, torch.float32)
            return stages[name].double()

        with float64_mode(torch):
            w_logits = zoo.forward(
                p64, cfg, t_cpu,
                frontend=None if f_cpu is None else f_cpu.double(),
                tap=record64)

    def compare(name, x):
        ref = stages[name]
        agree(zoo.logits_out(p_dev, cfg, x, torch.float32).cpu(),
              zoo.logits_out(p_cpu, cfg, ref, torch.float32),
              f"stage {name}", wit.get(name))
        return ref.to(dev)

    got = zoo.forward(p_dev, cfg, t_cpu.to(dev),
                      frontend=None if f_cpu is None else f_cpu.to(dev),
                      tap=compare).cpu()
    agree(got, want, "logits", w_logits)
    free = zoo.forward(p_dev, cfg, t_cpu.to(dev),
                       frontend=None if f_cpu is None else f_cpu.to(dev))
    free_cpu = zoo.forward(p_cpu, cfg, t_cpu, frontend=f_cpu)
    check(torch.equal(free.argmax(-1).cpu(), free_cpu.argmax(-1)),
          f"{agree.arch}: forward's greedy tokens differ between card and "
          "CPU")


def decode_check(torch, zoo, ss, cfg, p_dev, p_cpu, prompts, steps, agree,
                 p64=None):
    """``prefill_loop`` and ``steps`` decode steps on the card and on the
    CPU: equal greedy tokens; each decode step's logits also from the
    CPU's cache on the card (one step's error, not a run's), held by
    ``agree`` (with ``p64``, against a float64 step as the witness)."""
    dev = p_dev["embed"].device
    B = prompts.shape[0]
    dec = ss.make_decode_step(cfg)
    c_dev = zoo.init_cache(cfg, B, 16, dev)
    c_cpu = zoo.init_cache(cfg, B, 16, "cpu")
    tok_d, c_dev, n = ss.prefill_loop(dec, p_dev, prompts, c_dev)
    tok_c, c_cpu, _ = ss.prefill_loop(dec, p_cpu, prompts, c_cpu)
    check(torch.equal(tok_d.cpu(), tok_c), f"{agree.arch}: prefill_loop's "
          "greedy tokens differ between card and CPU")
    for step in range(steps):
        lc, _ = zoo.decode_step(p_cpu, cfg, tok_c, c_cpu, n)
        ld, _ = zoo.decode_step(p_dev, cfg, tok_c.to(dev),
                                {k: v.to(dev) for k, v in c_cpu.items()}, n)
        l64 = None
        if p64 is not None:
            with float64_mode(torch):
                l64, _ = zoo.decode_step(p64, cfg, tok_c,
                                         as_float64(c_cpu), n)
        agree(ld.cpu(), lc, f"decode step {step} logits", l64)
        tok_d, c_dev = dec(p_dev, tok_d, c_dev, n)
        tok_c, c_cpu = dec(p_cpu, tok_c, c_cpu, n)
        check(torch.equal(tok_d.cpu(), tok_c), f"{agree.arch}: decode step "
              f"{step}'s greedy tokens differ between card and CPU")
        n += 1


def left_pad(prompts, lens):
    L = int(max(lens))
    out = np.zeros((len(lens), L), np.int32)
    for i, n in enumerate(lens):
        out[i, L - n:] = prompts[i, :n]
    return out


def trained_scale(params):
    """The parameter tree with every stacked matrix (3 or more axes)
    rescaled to a standard deviation of 1/sqrt(fan_in), its
    next-to-last axis.  The builder, like the reference's, draws a
    stacked weight at 1/sqrt(n_layers) (its leading axis), and the smoke
    models' hidden states grow far above 1 (ROADMAP §C); at this scale
    the same layers run at activations of order 1."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = trained_scale(v)
        elif v.dim() >= 3:
            out[k] = v * (v.shape[-2] ** -0.5 / float(v.double().std()))
        else:
            out[k] = v
    return out


def smoke_arch_check(torch, arch, dev, seed):
    """One registry architecture at smoke width in float32, on ``dev``
    against the CPU, parameters from the port's seeded builder carried
    to ``dev`` as numpy: ``forward`` stage by stage (``stage_check``),
    then ``prefill_loop`` of a left-padded batch and three decode steps
    (``decode_check``).  Twice: at the builder's (the reference's)
    scale, the gate, with a float64 witness for what misses the
    tolerance (``Agreement``); and at trained scale
    (``trained_scale``), where every comparison must hold the tolerance.
    Returns the two ``Agreement``s."""
    from repro_torch.configs import registry
    from repro_torch.core import convert
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serve import serve_step as ss
    cfg = registry.get_smoke(arch)
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, (2, 8)).astype(np.int32)
    n_front = {"encdec": cfg.enc_positions,
               "vlm": cfg.img_tokens}.get(cfg.family)
    fr = None if n_front is None else (0.02 * rng.standard_normal(
        (2, n_front, cfg.d_model))).astype(np.float32)
    built = zoo.build_params(cfg, seed=0, device="cpu")
    out = []
    for p_cpu, witness in ((built, True), (trained_scale(built), False)):
        p_dev = convert.params_from_numpy(convert.params_to_numpy(p_cpu),
                                          device=dev)
        p64 = as_float64(p_cpu) if witness else None
        agree = Agreement(torch, arch)
        stage_check(torch, zoo, cfg, p_dev, p_cpu, toks, fr, agree, p64)
        decode_check(torch, zoo, ss, cfg, p_dev, p_cpu,
                     left_pad(toks, (4, 2)), 3, agree, p64)
        out.append(agree)
    return tuple(out)


def train_batch(cfg, rng, b, s):
    """A numpy training batch: tokens, labels, and the stub frontend of
    encdec and vlm, built as ``smoke_arch_check`` builds its inputs."""
    toks = rng.integers(1, cfg.vocab, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks.copy()}
    n_front = {"encdec": cfg.enc_positions,
               "vlm": cfg.img_tokens}.get(cfg.family)
    if n_front is not None:
        batch["frontend"] = (0.02 * rng.standard_normal(
            (b, n_front, cfg.d_model))).astype(np.float32)
    return batch


def train_step_check(torch, cfg, p_cpu, batch, dev, agree):
    """One ``make_train_step`` step on ``dev`` and one on the CPU from
    the same parameters (carried to ``dev`` as numpy) and batch:
    ``loss`` and ``grad_norm`` held by ``agree``; then the gradients
    (``train_step._grads_of``) on both, leaf by leaf, each held by
    ``agree``.  The witness of a miss is the CPU's run of the same code
    in float64 (remat off: the float64 mode does not reach a
    recomputation in the backward pass), made once, on the first miss.
    Returns the largest difference of an updated parameter leaf as a
    share of that leaf's norm, and the leaf's name: a reading, not a
    check (AdamW's first step moves each entry by about the learning
    rate, whatever its gradient's size)."""
    import dataclasses
    from repro_torch.core import convert
    from repro_torch.train import checkpoint as ckm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    p_dev = convert.params_from_numpy(convert.params_to_numpy(p_cpu),
                                      device=dev)
    b_cpu = {k: torch.as_tensor(v) for k, v in batch.items()}
    b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
    step = ts.make_train_step(cfg)
    pd, _, md = step(p_dev, opt.init(p_dev), b_dev)
    pc, _, mc = step(p_cpu, opt.init(p_cpu), b_cpu)
    fc = ckm._flatten(pc)
    share = max((float((v.cpu().double() - fc[k].double()).norm()
                       / fc[k].double().norm().clamp(min=1e-30)), k)
                for k, v in ckm._flatten(pd).items())
    del pd, pc, fc
    w64 = {}

    def witness(name):
        def run():
            if not w64:
                with float64_mode(torch):
                    b64 = {k: (v.double() if v.is_floating_point() else v)
                           for k, v in b_cpu.items()}
                    loss, g = ts._grads_of(
                        as_float64(p_cpu),
                        dataclasses.replace(cfg, remat="none"), b64)
                    w64.update({f"grad {k}": v
                                for k, v in ckm._flatten(g).items()})
                    w64.update(loss=loss, grad_norm=opt.global_norm(g))
            return w64[name]
        return run

    agree(md["loss"].cpu(), mc["loss"], "train step loss", witness("loss"))
    agree(md["grad_norm"].cpu(), mc["grad_norm"], "train step grad_norm",
          witness("grad_norm"))
    _, g_dev = ts._grads_of(p_dev, cfg, b_dev)
    del p_dev
    _, g_cpu = ts._grads_of(p_cpu, cfg, b_cpu)
    fc = ckm._flatten(g_cpu)
    for k, v in ckm._flatten(g_dev).items():
        agree(v.cpu(), fc[k], f"grad {k}", witness(f"grad {k}"))
    return share

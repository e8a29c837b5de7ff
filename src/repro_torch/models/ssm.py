"""Mamba2 / SSD (state-space duality) block: chunked scan and decode
step (the twin of ``repro.models.ssm``).

Chunked SSD (Dao & Gu 2024): quadratic attention-like compute inside
chunks of length Q, a linear state recurrence across chunks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as ly
from repro_torch.parallel import sharding as shd


def _causal_conv(x, w, b):
    """Depthwise causal conv1d.  x [B,S,ch], w [width,ch], b [ch]:
    out[t] = sum_j x[t - width + 1 + j] * w[j] + b, zeros before the
    start (a cross-correlation, as ``lax.conv_general_dilated``)."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = pad[:, 0:s] * w[0]
    for j in range(1, width):
        out = out + pad[:, j:j + s] * w[j]
    return out + b


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """xh [b,s,h,p], dt [b,s,h] (post-softplus), A [h] (negative),
    Bm/Cm [b,s,n].  Returns y [b,s,h,p] and the final state [b,h,n,p]."""
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    nc = s // q
    f32 = torch.float32
    xh = xh.reshape(b, nc, q, h, p)
    dt = dt.reshape(b, nc, q, h).to(f32)
    Bm = Bm.reshape(b, nc, q, n).to(f32)
    Cm = Cm.reshape(b, nc, q, n).to(f32)

    dA = dt * A.to(f32)                                   # [b,nc,q,h]
    cs = torch.cumsum(dA, dim=2)
    # intra-chunk decay L[q,k] = exp(cs[q]-cs[k]) for q>=k.  Mask BEFORE
    # the exp: out-of-mask diffs are positive and overflow
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]    # [b,nc,q,k,h]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device)
                     )[None, None, :, :, None]
    L = torch.exp(torch.where(tri, diff, torch.full_like(diff, -1e30)))

    xdt = xh.to(f32) * dt[..., None]                      # [b,nc,q,h,p]
    cb = torch.einsum("bcqn,bckn->bcqk", Cm, Bm)
    y_diag = torch.einsum("bcqk,bcqkh,bckhp->bcqhp", cb, L, xdt)

    # chunk states: S_c[h,n,p] = sum_k B[k,n] exp(cs[-1]-cs[k]) xdt[k]
    decay_end = torch.exp(cs[:, :, -1:, :] - cs)          # [b,nc,q,h]
    S = torch.einsum("bckn,bckh,bckhp->bchnp", Bm, decay_end, xdt)

    # inter-chunk recurrence; each chunk reads the state BEFORE it
    chunk_decay = torch.exp(cs[:, :, -1, :])              # [b,nc,h]
    carry = torch.zeros((b, h, n, p), dtype=f32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c][..., None, None] + S[:, c]
    prev_states = torch.stack(prev, dim=1)                # [b,nc,h,n,p]

    y_off = torch.einsum("bcqn,bchnp,bcqh->bcqhp", Cm, prev_states,
                         torch.exp(cs))
    return (y_diag + y_off).reshape(b, s, h, p), carry


def _split_proj(zxbcdt, di: int, n: int):
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


class _Split:
    """How one Mamba2 layer runs: meshless, every head on this rank; on
    one layer's blocks of a laid-out tree (``layers.Blocks``), the heads
    of this rank's ``ssm_heads`` block (read from ``dt_bias``'s spec).
    ``in_proj``'s columns split over ``ssm_proj`` straddle its ``z |
    xBC | dt`` segments, so its output is gathered whole (one
    all-gather) before the split, and the replicated conv runs on all
    channels; the scan runs on this rank's heads; the gated norm over
    all of ``d_inner`` sums its squares over the head axes; ``out_proj``
    takes this rank's rows (``ssm_proj``), from the heads' columns
    gathered whole where the two blocks differ, and one sum over its
    row axes ends the block."""

    def __init__(self, p, cfg, cdt):
        self.cfg = cfg
        specs = getattr(p, "specs", None)
        self.in_proj, self.out_proj = p["in_proj"], p["out_proj"]
        self.proj_axes = self.head_axes = self.row_axes = ()
        self.h0, self.r0 = 0, 0
        if specs is None:
            return
        mesh = shd.active_mesh()
        self.mesh = mesh
        self.proj_axes = ly.compute_axes(p["in_proj"], specs["in_proj"],
                                         (None, "ssm_proj"), 1)
        self.row_axes = ly.compute_axes(p["out_proj"], specs["out_proj"],
                                        ("ssm_proj", None), 0)
        self.in_proj = shd.gather_param(p["in_proj"].to(cdt), "fsdp",
                                        "ssm_proj", spec=specs["in_proj"])
        self.out_proj = shd.gather_param(p["out_proj"].to(cdt), "ssm_proj",
                                         "fsdp", spec=specs["out_proj"])
        self.head_axes = ly.split_over(specs["dt_bias"], 0)
        if self.head_axes:
            self.h0 = (shd.block_index(self.head_axes, mesh)
                       * p["dt_bias"].shape[0])
        if self.row_axes:
            self.r0 = (shd.block_index(self.row_axes, mesh)
                       * self.out_proj.shape[0])

    def project(self, x, cdt):
        """``x @ in_proj`` whole: ``(z, xBC, dt)``."""
        zx = x @ self.in_proj.to(cdt)
        if self.proj_axes:
            zx = ly.gather_last(zx, self.proj_axes)
        return _split_proj(zx, self.cfg.d_inner, self.cfg.ssm_state)

    def heads(self, hl: int):
        """The slice of ``d_inner``'s columns of this rank's heads."""
        hd = self.cfg.ssm_head_dim
        return slice(self.h0 * hd, (self.h0 + hl) * hd)

    def gate_out(self, y, z, p, cdt, seq=None):
        """This rank's heads' ``y`` ``[..., hl * hd]`` gated by ``z``,
        normed over all of ``d_inner`` and through ``out_proj`` (to this
        rank's block ``seq`` of the sequence)."""
        cols = self.heads(y.shape[-1] // self.cfg.ssm_head_dim)
        y = y.to(cdt) * F.silu(z[..., cols])
        y = ly.rms_norm(y, p["norm"][cols], self.cfg.norm_eps,
                        self.head_axes, self.cfg.d_inner)
        if self.head_axes != self.row_axes:
            if self.head_axes:
                y = ly.gather_last(y, self.head_axes)
            y = y[..., self.r0:self.r0 + self.out_proj.shape[0]]
        return ly.row_parallel(y, self.out_proj, cdt, self.row_axes, seq)


def mamba2_block(x, p, cfg, compute_dtype, seq=None):
    """Full Mamba2 block: in_proj -> conv -> SSD -> gated norm ->
    out_proj.  x [B,S,d] -> [B,S,d].  On a laid-out layer the scan runs
    on this rank's heads (:class:`_Split`).  The scan needs the whole
    sequence: with ``seq`` (a ``sharding.SeqBlock``; ``x`` whole) the
    output is this rank's block of it (``layers.row_parallel``)."""
    b, s, d = x.shape
    di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    cdt = compute_dtype
    sp = _Split(p, cfg, cdt)
    hl = p["dt_bias"].shape[0]
    z, xbc, dt = sp.project(x, cdt)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"].to(cdt),
                              p["conv_b"].to(cdt)))
    xs, Bm, Cm = xbc[..., sp.heads(hl)], xbc[..., di:di + n], \
        xbc[..., di + n:]
    dt = F.softplus(dt[..., sp.h0:sp.h0 + hl].float()
                    + p["dt_bias"].float())
    xh = xs.reshape(b, s, hl, hd)
    y, _ = ssd_chunked(xh, dt, p["A"], Bm, Cm, cfg.ssm_chunk)
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    return sp.gate_out(y.reshape(b, s, hl * hd), z, p, cdt, seq)


def mamba2_decode(x, state, p, cfg, compute_dtype):
    """Single-token decode.  x [B,1,d]; ``state`` holds ``ssm``
    [B,h,n,hd] (this rank's heads on a laid-out layer) and ``conv``
    [B,width-1,conv channels].  Returns (y, new state)."""
    b = x.shape[0]
    di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    cdt = compute_dtype
    f32 = torch.float32
    sp = _Split(p, cfg, cdt)
    hl = p["dt_bias"].shape[0]
    if state["ssm"].shape[1] != hl:
        raise ValueError(f"the ssm cache holds {state['ssm'].shape[1]} "
                         f"heads, the layer computes {hl}: lay the cache "
                         f"out as the params (init_cache(..., mesh=))")
    z, xbc, dt = sp.project(x, cdt)
    conv_buf = torch.cat([state["conv"], xbc], dim=1)      # rolling cache
    w = p["conv_w"].to(cdt)                                # [width, ch]
    xbc1 = (conv_buf * w[None]).sum(dim=1, keepdim=True) + \
        p["conv_b"].to(cdt)
    xbc1 = F.silu(xbc1)
    xs, Bm, Cm = (xbc1[..., sp.heads(hl)], xbc1[..., di:di + n],
                  xbc1[..., di + n:])
    dt = F.softplus(dt[..., sp.h0:sp.h0 + hl].float()
                    + p["dt_bias"].float())                # [B,1,hl]
    xh = xs.reshape(b, hl, hd).to(f32)
    dA = torch.exp(dt[:, 0, :] * p["A"].to(f32))          # [B,hl]
    ssm = state["ssm"] * dA[:, :, None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", Bm[:, 0].to(f32), dt[:, 0], xh)
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].to(f32), ssm)
    y = y + p["D"].to(f32)[None, :, None] * xh
    out = sp.gate_out(y.reshape(b, 1, hl * hd), z, p, cdt)
    return out, {"ssm": ssm, "conv": conv_buf[:, 1:]}

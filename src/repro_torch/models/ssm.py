"""Mamba2 / SSD (state-space duality) block: chunked scan and decode
step (the twin of ``repro.models.ssm``, meshless).

Chunked SSD (Dao & Gu 2024): quadratic attention-like compute inside
chunks of length Q, a linear state recurrence across chunks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm


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


def _gate_out(y, z, p, cfg, compute_dtype):
    y = y.to(compute_dtype) * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(compute_dtype)


def mamba2_block(x, p, cfg, compute_dtype):
    """Full Mamba2 block: in_proj -> conv -> SSD -> gated norm ->
    out_proj.  x [B,S,d] -> [B,S,d]."""
    b, s, d = x.shape
    di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    h = cfg.ssm_heads
    cdt = compute_dtype
    z, xbc, dt = _split_proj(x @ p["in_proj"].to(cdt), di, n)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"].to(cdt),
                              p["conv_b"].to(cdt)))
    xs, Bm, Cm = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    xh = xs.reshape(b, s, h, hd)
    y, _ = ssd_chunked(xh, dt, p["A"], Bm, Cm, cfg.ssm_chunk)
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    return _gate_out(y.reshape(b, s, di), z, p, cfg, cdt)


def mamba2_decode(x, state, p, cfg, compute_dtype):
    """Single-token decode.  x [B,1,d]; ``state`` holds ``ssm``
    [B,h,n,hd] and ``conv`` [B,width-1,conv channels].  Returns
    (y, new state)."""
    b = x.shape[0]
    di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    h = cfg.ssm_heads
    cdt = compute_dtype
    f32 = torch.float32
    z, xbc, dt = _split_proj(x @ p["in_proj"].to(cdt), di, n)
    conv_buf = torch.cat([state["conv"], xbc], dim=1)      # rolling cache
    w = p["conv_w"].to(cdt)                                # [width, ch]
    xbc1 = (conv_buf * w[None]).sum(dim=1, keepdim=True) + \
        p["conv_b"].to(cdt)
    xbc1 = F.silu(xbc1)
    xs, Bm, Cm = (xbc1[..., :di], xbc1[..., di:di + n],
                  xbc1[..., di + n:])
    dt = F.softplus(dt.float() + p["dt_bias"].float())    # [B,1,h]
    xh = xs.reshape(b, h, hd).to(f32)
    dA = torch.exp(dt[:, 0, :] * p["A"].to(f32))          # [B,h]
    ssm = state["ssm"] * dA[:, :, None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", Bm[:, 0].to(f32), dt[:, 0], xh)
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].to(f32), ssm)
    y = y + p["D"].to(f32)[None, :, None] * xh
    out = _gate_out(y.reshape(b, 1, di), z, p, cfg, cdt)
    return out, {"ssm": ssm, "conv": conv_buf[:, 1:]}

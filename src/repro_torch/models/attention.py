"""GQA/MQA/MHA attention: full, blockwise (online softmax) and decode
(the twin of ``repro.models.attention``, meshless).

Blockwise attention runs over KV chunks with a running (max, sum):
O(seq) memory.  Masks: causal, prefix-LM (paligemma), full (whisper
encoder / cross-attention).  The dispatch rule and its constants are
the reference's: they pick the summation order, so they change the
rounding.
"""

from __future__ import annotations

import torch

BLOCKWISE_THRESHOLD = 2048
KV_CHUNK = 1024


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _mask_bias(mask_mode: str, q_pos, k_pos, prefix_len: int, dtype):
    """[q, k] additive bias, or None for the full mask."""
    if mask_mode == "full":
        return None
    ok = k_pos[None, :] <= q_pos[:, None]
    if mask_mode == "prefix":
        ok = ok | (k_pos[None, :] < prefix_len)
    zero = torch.zeros((), dtype=dtype, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))


def full_attention(q, k, v, mask_mode: str = "causal",
                   prefix_len: int = 0):
    """q [b,sq,h,d], k/v [b,sk,kv,d] (kv repeated to h here)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    dev = q.device
    bias = _mask_bias(mask_mode, torch.arange(sq, device=dev),
                      torch.arange(sk, device=dev),
                      prefix_len, torch.float32)
    l32 = logits.float()
    if bias is not None:
        l32 = l32 + bias[None, None]
    probs = torch.softmax(l32, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def blockwise_attention(q, k, v, mask_mode: str = "causal",
                        prefix_len: int = 0, kv_chunk: int = KV_CHUNK):
    """Online-softmax attention over KV chunks: O(sq * kv_chunk) live
    memory instead of O(sq * sk)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = d ** -0.5
    n_chunks = sk // kv_chunk
    k = k.reshape(b, n_chunks, kv_chunk, h, d)
    v = v.reshape(b, n_chunks, kv_chunk, h, d)
    dev = q.device
    q_pos = torch.arange(sq, device=dev)
    m = torch.full((b, h, sq), -1e30, dtype=torch.float32, device=dev)
    s = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        k_c, v_c = k[:, c], v[:, c]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k_c).float() * scale
        k_pos = c * kv_chunk + torch.arange(kv_chunk, device=dev)
        bias = _mask_bias(mask_mode, q_pos, k_pos, prefix_len,
                          torch.float32)
        if bias is not None:
            logits = logits + bias[None, None]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        s = s * alpha + p.sum(dim=-1)
        o = (o * alpha[..., None]
             + torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype), v_c).float())
        m = m_new
    out = (o / torch.clamp(s, min=1e-30)[..., None]).to(q.dtype)
    return out.transpose(1, 2)   # [b, sq, h, d]


def _valid(sk: int, cache_len, device):
    return (torch.arange(sk, device=device)
            < cache_len)[None, None, None, None, :]


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-position decode: q [b,1,h,d] against cache [b,sk,kv,d].
    Grouped-query einsum: the KV cache is never broadcast to h heads.
    Positions >= cache_len are masked out."""
    b, sq, h, d = q.shape
    sk, kv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, d)
    scale = d ** -0.5
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_cache).float() * scale
    logits = torch.where(_valid(sk, cache_len, q.device), logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v_cache)
    return out.reshape(b, sq, h, d)


def quantize_kv(x):
    """Per-token symmetric int8 quantization: x [b,s,kv,d] ->
    (int8 [b,s,kv,d], scale float32 [b,s,kv]).  Each token carries its
    own scale, so the cache is never requantized."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1), min=1e-6)
    q = torch.clamp(torch.round(x32 / scale[..., None] * 127.0), -127, 127)
    return q.to(torch.int8), scale


def decode_attention_q8(q, k_q, v_q, k_sc, v_sc, cache_len):
    """Grouped decode attention over an int8 KV cache.  The scales fold
    into the attention algebra instead of dequantizing the cache:
    logits = (q @ k_q^T) * k_sc and out = probs' @ v_q with
    probs' = probs * v_sc."""
    b, sq, h, d = q.shape
    sk, kv = k_q.shape[1], k_q.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, d)
    scale = d ** -0.5
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                          k_q.float() / 127.0) * scale
    logits = logits * k_sc.permute(0, 2, 1)[:, :, None, None, :]
    logits = torch.where(_valid(sk, cache_len, q.device), logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    probs = probs * (v_sc.permute(0, 2, 1)[:, :, None, None, :] / 127.0)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs.to(q.dtype),
                       v_q.to(q.dtype))
    return out.reshape(b, sq, h, d)


def attention(q, k, v, mask_mode: str = "causal", prefix_len: int = 0):
    sq, sk = q.shape[1], k.shape[1]
    if sq == sk and sk > BLOCKWISE_THRESHOLD and sk % KV_CHUNK == 0:
        return blockwise_attention(q, k, v, mask_mode, prefix_len)
    return full_attention(q, k, v, mask_mode, prefix_len)

"""Shared transformer layers of the port: norms, linears, a checkpointed
scan, RoPE and M-RoPE, GQA attention over a full sequence (dense, or
blockwise with its own backward) and with an exact KV cache or ring
buffer, cross-attention, and the SwiGLU and GELU MLPs, as
``src/repro/models/layers.py`` computes them.

Parameters live in ``nn.Module`` containers whose attribute names are the
JAX package's dictionary keys (``p.wq`` for ``p["wq"]``); weights keep its
``[d_in, d_out]`` layout, so a layer is ``x @ w``.  The casts are the
reference's: RMSNorm and RoPE run in float32 and cast back to the
activation dtype, attention runs in float32 and its output is cast back
before the output projection.
"""
from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r}: expected one of {sorted(DTYPES)}")
    return DTYPES[name]


class Init:
    """Makes parameters on ``device``: standard normals scaled, drawn from an
    explicit generator on the generator's own device, or (``generator=None``)
    uninitialised tensors that a caller fills, as
    ``convert.lm_params_from_numpy`` does."""

    def __init__(self, generator: torch.Generator | None, *,
                 dtype: torch.dtype, device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = device

    def normal(self, shape: tuple, scale: float,
               dtype: torch.dtype | None = None) -> nn.Parameter:
        """Standard normals times ``scale`` in ``dtype`` (default: the
        model's)."""
        dtype = self.dtype if dtype is None else dtype
        if self.generator is None:
            t = torch.empty(shape, dtype=dtype, device=self.device)
        else:
            t = torch.randn(shape, generator=self.generator,
                            device=self.generator.device)
            t = t.mul_(scale).to(device=self.device, dtype=dtype)
        return nn.Parameter(t, requires_grad=False)

    def const(self, shape: tuple, value: float) -> nn.Parameter:
        t = torch.full(shape, value, dtype=self.dtype, device=self.device)
        return nn.Parameter(t, requires_grad=False)


def _tree_map(fn, *nodes):
    """``fn`` over the tensors at the same place in nests of tuples, lists
    and dicts of one structure."""
    n0 = nodes[0]
    if isinstance(n0, (tuple, list)):
        return type(n0)(_tree_map(fn, *parts) for parts in zip(*nodes))
    if isinstance(n0, dict):
        return {k: _tree_map(fn, *(n[k] for n in nodes)) for k in n0}
    return fn(*nodes)


def checkpointed_scan(step, init, xs, *, chunk: int = 128):
    """``lax.scan`` of ``step(carry, x) -> (carry, y)`` over the leading
    axis of ``xs`` (a tensor or a nest of tuples / dicts of them), with
    O(S/chunk + chunk) backward memory: the scan runs in chunks (the chunk
    halved until it divides S), and under autograd each chunk is
    recomputed in the backward (``torch.utils.checkpoint``), so only the
    carries at chunk borders are kept.  Returns (carry, ys stacked on a
    leading S axis)."""
    lengths = []
    _tree_map(lambda x: lengths.append(x.shape[0]), xs)
    s = lengths[0]
    c = min(chunk, s)
    while s % c:
        c //= 2

    def run(carry, xc):
        ys = []
        for t in range(c):
            carry, y = step(carry, _tree_map(lambda x: x[t], xc))
            ys.append(y)
        return carry, _tree_map(lambda *ts: torch.stack(ts), *ys)

    carry, chunks = init, []
    for lo in range(0, s, c):
        xc = _tree_map(lambda x: x[lo:lo + c], xs)
        if torch.is_grad_enabled():
            carry, ys = checkpoint(run, carry, xc, use_reentrant=False)
        else:
            carry, ys = run(carry, xc)
        chunks.append(ys)
    return carry, _tree_map(lambda *ts: torch.cat(ts), *chunks)


def dense_init(init: Init, d_in: int, d_out: int,
               scale: float | None = None,
               dtype: torch.dtype | None = None) -> nn.Parameter:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return init.normal((d_in, d_out), scale, dtype)


def rmsnorm_init(init: Init, d: int) -> nn.Parameter:
    return init.const((d,), 1.0)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) * w in float32, cast back to x's dtype."""
    return F.rms_norm(x.float(), (x.shape[-1],), w.float(), eps).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    """[head_dim/2] inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / theta ** exps


def rope_rotation(positions: torch.Tensor, head_dim: int,
                  theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotary angles, [..., S, 1, hd/2] f32, for
    positions [..., S]: every layer of a decode step shares them."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs           # [..., S, hd/2]
    angles = angles[..., None, :]                           # [..., S, 1, hd/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, *,
               rotation: tuple | None = None) -> torch.Tensor:
    """Rotary embedding.  x: [..., S, H, hd]; positions: [..., S] int;
    ``rotation`` is ``rope_rotation(positions, hd, theta)`` when the caller
    has it already."""
    if rotation is None:
        rotation = rope_rotation(positions, x.shape[-1], theta)
    cos, sin = rotation
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_sections(head_dim: int) -> tuple[int, int, int]:
    """Qwen2-VL's split of the head_dim/2 frequency slots into (temporal,
    height, width) sections: 1/4, 3/8, 3/8 (16/24/24 of a 128 head)."""
    half = head_dim // 2
    s1 = half // 4
    s2 = (half - s1) // 2
    return s1, s2, half - s1 - s2


def mrope_rotation(positions: torch.Tensor, head_dim: int, theta: float,
                   sections: tuple | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the multimodal rotary angles, [B, S, 1, hd/2] f32:
    frequency slot j of section i turns by the position of grid row i.
    positions: [3, B, S] int (t/h/w; equal rows, as for pure text, give
    standard RoPE)."""
    half = head_dim // 2
    sections = mrope_sections(head_dim) if sections is None else sections
    if sum(sections) != half:
        raise ValueError(f"sections {sections} do not sum to {half}")
    freqs = rope_freqs(head_dim, theta, positions.device)
    sect = torch.cat([torch.full((n,), i, dtype=torch.long,
                                 device=positions.device)
                      for i, n in enumerate(sections)])       # [half]
    pos = positions.movedim(0, -1).float()                   # [B, S, 3]
    angles = (pos[..., sect] * freqs)[..., None, :]          # [B,S,1,half]
    return torch.cos(angles), torch.sin(angles)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple | None = None) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL).  x: [B, S, H, hd]; positions: [3, B, S]
    int."""
    return apply_rope(x, positions, theta, rotation=mrope_rotation(
        positions, x.shape[-1], theta, sections))


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """Weights of (grouped-query) attention: wq, wk, wv, wo, and q_norm /
    k_norm with ``qk_norm``, bq / bk / bv with ``qkv_bias``."""

    def __init__(self, init: Init, cfg):
        super().__init__()
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = dense_init(init, d, h * hd)
        self.wk = dense_init(init, d, hkv * hd)
        self.wv = dense_init(init, d, hkv * hd)
        self.wo = dense_init(init, h * hd, d)
        if cfg.qkv_bias:
            self.bq = init.const((h * hd,), 0.0)
            self.bk = init.const((hkv * hd,), 0.0)
            self.bv = init.const((hkv * hd,), 0.0)
        if cfg.qk_norm:
            self.q_norm = rmsnorm_init(init, hd)
            self.k_norm = rmsnorm_init(init, hd)


def attention_init(init: Init, cfg) -> Attention:
    return Attention(init, cfg)


def _project_qkv(p: Attention, x: torch.Tensor, cfg, positions: torch.Tensor,
                 rotation: tuple | None = None, mrope_positions=None):
    """x [B,S,d] -> q [B,S,H,hd], k, v [B,S,Hkv,hd], rotated: by M-RoPE
    when the config has it and ``mrope_positions`` [3,B,S] are given (the
    JAX package falls back to standard RoPE without them), else by RoPE
    when the config uses it; ``rotation`` is the (cos, sin) to rotate by
    when the caller has it (a decode step's layers share one)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    mrope = cfg.mrope and mrope_positions is not None
    if mrope or cfg.use_rope:
        if rotation is None:
            rotation = (mrope_rotation(mrope_positions, hd, cfg.rope_theta)
                        if mrope else rope_rotation(positions, hd,
                                                    cfg.rope_theta))
        # one rotation of the query and key heads together (elementwise:
        # the same values as rotating each)
        qk = apply_rope(torch.cat([q, k], dim=2), positions, cfg.rope_theta,
                        rotation=rotation)
        q, k = qk[:, :, :h], qk[:, :, h:]
    return q, k, v


def attention_decode(
    p: Attention, x: torch.Tensor, cfg, *, cache_k: torch.Tensor,
    cache_v: torch.Tensor, pos: torch.Tensor,
    write_pos: torch.Tensor | None = None, rotation: tuple | None = None,
    mrope_positions: torch.Tensor | None = None,
):
    """One decode step with exact attention.  x [B,1,d]; cache_k/v
    [B,S,Hkv,hd]; pos [B]; ``mrope_positions`` [3,B,1].  The new key and
    value are written into the caches in place at ``write_pos`` (default
    ``pos``; a ring buffer passes ``pos % ring``, and once ``pos`` passes
    the ring every slot is valid); returns (out [B,1,d], cache_k,
    cache_v)."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s_max = cache_k.shape[1]
    if write_pos is None:
        write_pos = pos
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None], rotation,
                                   mrope_positions)
    rows = torch.arange(b, device=x.device)
    slot = write_pos.long().clamp(0, s_max - 1)
    cache_k[rows, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v_new[:, 0].to(cache_v.dtype)

    group = h // hkv
    qg = q.reshape(b, 1, hkv, group, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          cache_k.float()) / math.sqrt(hd)
    t_idx = torch.arange(s_max, device=x.device)[None, :]
    n_live = torch.clamp_max(pos[:, None] + 1, s_max)
    valid = t_idx < n_live
    logits = torch.where(valid[:, None, None, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, cache_v.float())
    out = out.reshape(b, 1, h * hd).to(x.dtype) @ p.wo
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# full-sequence attention (training / prefill)
# ---------------------------------------------------------------------------

def _bw_chunks(s: int, t: int, q_chunk: int, kv_chunk: int, causal: bool,
               window: int | None) -> tuple[int, int, list[tuple[int, int]]]:
    """(q chunk, kv chunk, live block pairs): each chunk halved until it
    divides its length; a pair that the causal mask or the window masks
    whole is left out."""
    qc = q_chunk
    while s % qc:
        qc //= 2
    kc = kv_chunk
    while t % kc:
        kc //= 2

    def block_live(qi, ki):
        q_lo, q_hi = qi * qc, qi * qc + qc - 1
        k_lo, k_hi = ki * kc, ki * kc + kc - 1
        if causal and k_lo > q_hi:
            return False
        if window is not None and k_hi <= q_lo - window:
            return False
        return True

    pairs = [(qi, ki) for qi in range(s // qc) for ki in range(t // kc)
             if block_live(qi, ki)]
    return qc, kc, pairs


def _bw_mask(qi: int, ki: int, qc: int, kc: int, causal: bool,
             window: int | None, device) -> torch.Tensor:
    gq = qi * qc + torch.arange(qc, device=device)
    gk = ki * kc + torch.arange(kc, device=device)
    mask = torch.ones((qc, kc), dtype=torch.bool, device=device)
    if causal:
        mask &= gk[None, :] <= gq[:, None]
    if window is not None:
        mask &= gk[None, :] > gq[:, None] - window
    return mask


def _bw_forward(q, k, v, scale, causal, window, q_chunk, kv_chunk):
    """q [b,s,hkv,g,hd], k [b,t,hkv,hd], v [b,t,hkv,dv] -> (out
    [b,s,hkv,g,dv] f32, lse [b,hkv,g,s] f32): a running max and sum over
    the live blocks."""
    b, s, hkv, g, _ = q.shape
    t, dv = k.shape[1], v.shape[-1]
    qc, kc, pairs = _bw_chunks(s, t, q_chunk, kv_chunk, causal, window)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((b, hkv, g, s), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s, hkv, g, dv), dtype=torch.float32,
                      device=q.device)
    for qi, ki in pairs:
        qs, ks = slice(qi * qc, qi * qc + qc), slice(ki * kc, ki * kc + kc)
        logits = torch.einsum("bskgd,btkd->bkgst", qf[:, qs], kf[:, ks]) \
            * scale
        mask = _bw_mask(qi, ki, qc, kc, causal, window, q.device)
        logits = torch.where(mask, logits, -1e30)
        m_old, l_old = m[..., qs], l[..., qs]
        m_new = torch.maximum(m_old, logits.amax(dim=-1))
        alpha = torch.exp(m_old - m_new)
        p = torch.exp(logits - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        l[..., qs] = l_old * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bskgd", p, vf[:, ks])
        acc[:, qs] = acc[:, qs] * alpha.movedim(3, 1)[..., None] + pv
        m[..., qs] = m_new
    lse = m + torch.log(torch.clamp_min(l, 1e-30))
    out = acc / torch.clamp_min(l.movedim(3, 1)[..., None], 1e-30)
    return out, lse


def _bw_backward(q, k, v, out, lse, dout, scale, causal, window, q_chunk,
                 kv_chunk):
    """FlashAttention-2-style backward: each live block recomputed from the
    saved logsumexp, so memory stays O(S), never O(S^2)."""
    s, t = q.shape[1], k.shape[1]
    qc, kc, pairs = _bw_chunks(s, t, q_chunk, kv_chunk, causal, window)
    qf, kf, vf = q.float(), k.float(), v.float()
    doutf = dout.float()
    delta = (doutf * out).sum(dim=-1).movedim(1, 3)      # [b,hkv,g,s]
    dq, dk, dvac = (torch.zeros_like(x) for x in (qf, kf, vf))
    for qi, ki in pairs:
        qs, ks = slice(qi * qc, qi * qc + qc), slice(ki * kc, ki * kc + kc)
        qblk, kblk, vblk, do_q = qf[:, qs], kf[:, ks], vf[:, ks], doutf[:, qs]
        logits = torch.einsum("bskgd,btkd->bkgst", qblk, kblk) * scale
        mask = _bw_mask(qi, ki, qc, kc, causal, window, q.device)
        p = torch.exp(logits - lse[..., qs, None])
        p = torch.where(mask, p, 0.0)                    # [b,k,g,qc,kc]
        dvac[:, ks] += torch.einsum("bkgst,bskgd->btkd", p, do_q)
        dp = torch.einsum("bskgd,btkd->bkgst", do_q, vblk)
        ds = p * (dp - delta[..., qs, None]) * scale
        dq[:, qs] += torch.einsum("bkgst,btkd->bskgd", ds, kblk)
        dk[:, ks] += torch.einsum("bkgst,bskgd->btkd", ds, qblk)
    return dq.to(q.dtype), dk.to(k.dtype), dvac.to(v.dtype)


class _BlockwiseSDPA(torch.autograd.Function):
    """``jax.custom_vjp`` of ``_bw_sdpa``: the forward saves (q, k, v, out,
    lse), the backward recomputes each block from them."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, q_chunk, kv_chunk):
        out, lse = _bw_forward(q, k, v, scale, causal, window, q_chunk,
                               kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (scale, causal, window, q_chunk, kv_chunk)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bw_backward(q, k, v, out, lse, dout, *ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def blockwise_sdpa(q, k, v, *, scale: float, causal: bool,
                   window: int | None = None, q_chunk: int = 256,
                   kv_chunk: int = 512) -> torch.Tensor:
    """Flash-style blockwise attention with static causal block skipping.

    q: [B,S,Hkv,G,hd]; k/v: [B,T,Hkv,hd] (dv may differ from hd).  Memory is
    O(S + chunk^2) in forward AND backward (the backward recomputes blocks
    from the saved logsumexp, FlashAttention-2 style); block pairs fully
    masked by causality/windowing are skipped.  Returns [B,S,H,dv].
    """
    b, s, hkv, g, _ = q.shape
    out = _BlockwiseSDPA.apply(q, k, v, scale, causal, window, q_chunk,
                               kv_chunk)
    return out.reshape(b, s, hkv * g, v.shape[-1])


# full-sequence attention switches to the blockwise path above this size
_BLOCKWISE_THRESHOLD = 2048


def _sdpa(q, k, v, mask, *, scale: float) -> torch.Tensor:
    """[B,S,H,hd] x [B,T,Hkv,hd] -> [B,S,H,hd] with GQA head grouping, in
    float32, masked logits at -1e30."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def causal_mask(s: int, device=None) -> torch.Tensor:
    return torch.tril(torch.ones((s, s), dtype=torch.bool, device=device))


def sliding_window_mask(s: int, window: int, device=None) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    return (j <= i) & (j > i - window)


def attention(p: Attention, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              causal: bool = True, window: int | None = None,
              mrope_positions: torch.Tensor | None = None,
              segment_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence attention (training / prefill): the blockwise path
    from ``_BLOCKWISE_THRESHOLD`` tokens on, the dense one below."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions,
                           mrope_positions=mrope_positions)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if s >= _BLOCKWISE_THRESHOLD and segment_mask is None:
        hkv = cfg.n_kv_heads
        qg = q.reshape(b, s, hkv, cfg.n_heads // hkv, cfg.head_dim)
        out = blockwise_sdpa(qg, k, v, scale=scale, causal=causal,
                             window=window)
        return out.reshape(b, s, -1) @ p.wo
    if window is not None:
        mask = sliding_window_mask(s, window, x.device)[None]
    elif causal:
        mask = causal_mask(s, x.device)[None]
    else:
        mask = torch.ones((1, s, s), dtype=torch.bool, device=x.device)
    if segment_mask is not None:
        mask = mask & segment_mask
    out = _sdpa(q, k, v, mask, scale=scale)
    return out.reshape(b, s, -1) @ p.wo


class CrossAttention(nn.Module):
    """Decoder-to-encoder attention weights: wq, wk, wv [d, H*hd], wo."""

    def __init__(self, init: Init, cfg):
        super().__init__()
        d, hd = cfg.d_model, cfg.n_heads * cfg.head_dim
        self.wq = dense_init(init, d, hd)
        self.wk = dense_init(init, d, hd)
        self.wv = dense_init(init, d, hd)
        self.wo = dense_init(init, hd, d)


def cross_attention_init(init: Init, cfg) -> CrossAttention:
    return CrossAttention(init, cfg)


def cross_attention(p: CrossAttention, x: torch.Tensor, memory: torch.Tensor,
                    cfg) -> torch.Tensor:
    """Decoder-to-encoder attention (no RoPE, no mask).  x [B,S,d]; memory
    [B,T,d]."""
    b, s, _ = x.shape
    t = memory.shape[1]
    h, hd = cfg.n_heads, cfg.head_dim
    q = (x @ p.wq).reshape(b, s, h, hd)
    k = (memory @ p.wk).reshape(b, t, h, hd)
    v = (memory @ p.wv).reshape(b, t, h, hd)
    if max(s, t) >= _BLOCKWISE_THRESHOLD:
        out = blockwise_sdpa(q.reshape(b, s, h, 1, hd), k, v,
                             scale=1.0 / math.sqrt(hd), causal=False)
    else:
        out = _sdpa(q, k, v, None, scale=1.0 / math.sqrt(hd))
    return out.reshape(b, s, -1) @ p.wo


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU weights: w_gate, w_up [d, ff], w_down [ff, d]."""

    def __init__(self, init: Init, d_model: int, d_ff: int):
        super().__init__()
        self.w_gate = dense_init(init, d_model, d_ff)
        self.w_up = dense_init(init, d_model, d_ff)
        self.w_down = dense_init(init, d_ff, d_model)


def mlp_init(init: Init, d_model: int, d_ff: int) -> MLP:
    return MLP(init, d_model, d_ff)


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU feed-forward."""
    return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down


class GeluMLP(nn.Module):
    """Plain GELU feed-forward weights (whisper): w_up [d, ff], w_down."""

    def __init__(self, init: Init, d_model: int, d_ff: int):
        super().__init__()
        self.w_up = dense_init(init, d_model, d_ff)
        self.w_down = dense_init(init, d_ff, d_model)


def gelu_mlp_init(init: Init, d_model: int, d_ff: int) -> GeluMLP:
    return GeluMLP(init, d_model, d_ff)


def gelu_mlp(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    """GELU feed-forward; ``jax.nn.gelu``'s default is the tanh
    approximation."""
    return F.gelu(x @ p.w_up, approximate="tanh") @ p.w_down

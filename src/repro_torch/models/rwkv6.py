"""RWKV6 "Finch" block (port of ``repro/models/rwkv6.py``): attention-free
token mixing with a data-dependent decay.

Time mix (per head h, head size N)::

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t
    y_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)

with the decay ``w_t = exp(-exp(w0 + tanh(x_w A) B))`` and token-shift
interpolation feeding every projection; channel mix ``k = relu(x_k W_k)²;
y = σ(x_r W_r) ⊙ (k W_v)``.

Amber mapping, as in the JAX package: the r/k/v/g projections prune under
category ``q_proj``, the output projection is ``o_proj`` (skipped), the
channel mix's W_k is ``gate_proj`` and W_v ``down_proj`` (pruned), W_r
``up_proj`` (skipped); the decay LoRA stays dense.  The parameters keep the
JAX key names as attributes (``tm.r_proj``, ``cm.gate_proj``, ...).

dtypes are the reference's: ``S``, ``w0``, ``u`` and the decay are
float32, r/k/v are cast to float32 for the recurrence, and its output goes
back to the model dtype before the per-head group norm (population
variance).  The block has no layer norm of its own.

A chunk of one token takes the single-step recurrence
(:func:`_time_mix_step`, as decode does).  A longer one takes the chunked
form (:func:`wkv_chunked`) where the reference runs a sequential
``lax.scan``: the same function, in sub-chunks of 16 tokens.  Within a
sub-chunk every pairwise decay is ``exp(c_{t-1} - c_s)`` of the
sub-chunk's own cumulative log decays (never above 1, never a division by
a decay product), so it is as stable as the step loop.  The states
leaving the sub-chunks are one linear recurrence over them, evaluated by
doubling in log2 of their count levels: ~57 launches a layer for a
256-token chunk (its 16 sub-chunks: 4 levels), where the token loop
(:func:`wkv_scan`, its plain twin, which the tests hold it to) runs 769,
and a 4096-token training row records 8 levels where a loop over its 256
sub-chunks would record 256 steps and their backward.  The recurrence is plain torch: the
JAX package computes it outside any Pallas kernel (a chunked WKV kernel is
future work there too).  :func:`rwkv6_block` returns the new state out of
place; the model writes it into its cache.

In a sharded cell (``launch/cells.py``) ``S`` is held on its heads: the
recurrence runs on the rank's heads of r/k/v/lw/u and its shard of ``S``
(``sharding.head_state_local``), and the output, cast to the model dtype,
is gathered back whole before the group norm.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.policy import SparsityPolicy
from repro_torch.distributed import sharding
from repro_torch.layers.linear import init_linear, sparse_linear
from repro_torch.models.common import LayerNorm

__all__ = ["RWKV6Block", "init_rwkv6_state", "rwkv6_block", "wkv_chunked", "wkv_scan"]

_LORA = 64
_SUB = 16          # tokens a sub-chunk of wkv_chunked


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class TimeMix(nn.Module):
    def __init__(self, d: int, n_heads: int, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        hd = d // n_heads

        def mix():
            return _param((torch.rand(d, generator=generator, device=device) * 0.1 + 0.45)
                          .to(dtype))

        self.mix_r, self.mix_k, self.mix_v, self.mix_w, self.mix_g = (mix() for _ in range(5))
        self.r_proj = init_linear(d, d, **kw)
        self.k_proj_tm = init_linear(d, d, **kw)
        self.v_proj_tm = init_linear(d, d, **kw)
        self.g_proj = init_linear(d, d, **kw)
        self.o_proj = init_linear(d, d, **kw)
        self.w0 = _param(torch.full((d,), -4.0, device=device))
        self.w_A = _param((torch.randn(d, _LORA, generator=generator, device=device) * 0.01)
                          .to(dtype))
        self.w_B = _param((torch.randn(_LORA, d, generator=generator, device=device) * 0.01)
                          .to(dtype))
        self.u = _param(torch.zeros(n_heads, hd, device=device))
        self.ln_x = LayerNorm(d, dtype=dtype, device=device)


class ChannelMix(nn.Module):
    def __init__(self, d: int, d_ff: int, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)

        def mix():
            return _param((torch.rand(d, generator=generator, device=device) * 0.1 + 0.45)
                          .to(dtype))

        self.mix_k, self.mix_r = mix(), mix()
        self.gate_proj = init_linear(d, d_ff, **kw)     # W_k
        self.down_proj = init_linear(d_ff, d, **kw)     # W_v
        self.up_proj = init_linear(d, d, **kw)          # W_r


class RWKV6Block(nn.Module):
    """``tm`` (time mix) and ``cm`` (channel mix)."""

    def __init__(self, d: int, d_ff: int, n_heads: int, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.tm = TimeMix(d, n_heads, **kw)
        self.cm = ChannelMix(d, d_ff, **kw)


def init_rwkv6_state(batch: int, d: int, n_heads: int, dtype, device) -> Dict[str, torch.Tensor]:
    hd = d // n_heads
    return {"tm_shift": torch.zeros(batch, d, dtype=dtype, device=device),
            "cm_shift": torch.zeros(batch, d, dtype=dtype, device=device),
            "S": torch.zeros(batch, n_heads, hd, hd, dtype=torch.float32, device=device)}


def _group_norm(x: torch.Tensor, p: LayerNorm, n_heads: int, eps: float = 1e-5) -> torch.Tensor:
    b, t, d = x.shape
    xh = x.reshape(b, t, n_heads, d // n_heads).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(b, t, d) * p.w + p.b).to(x.dtype)


def _time_mix_step(S: torch.Tensor, r, k, v, w, u: torch.Tensor, n_heads: int):
    """One recurrence step, the reference's form: ``S (B, H, N, N)``
    float32, inputs ``(B, d)``.  Returns (new S, y ``(B, d)`` float32)."""
    b, d = r.shape
    hd = d // n_heads
    rh = r.reshape(b, n_heads, hd).float()
    kh = k.reshape(b, n_heads, hd).float()
    vh = v.reshape(b, n_heads, hd).float()
    wh = w.reshape(b, n_heads, hd)
    kv = kh[..., :, None] * vh[..., None, :]
    y = torch.einsum("bhk,bhkn->bhn", rh, S + u[None, :, :, None] * kv)
    return wh[..., :, None] * S + kv, y.reshape(b, d)


def wkv_scan(S: torch.Tensor, r, k, v, w, u: torch.Tensor, n_heads: int):
    """The recurrence over ``(B, T, d)`` inputs (``w`` float32) from state
    ``S``, token by token: the bonus term ``(r_t·(u⊙k_t)) v_t`` for all t
    at once, then per token ``y_t += r_t S`` and ``S = w_t ⊙ S + k_tᵀ v_t``
    (three launches).  The plain twin of :func:`wkv_chunked`.  Returns (new
    S, y ``(B, T, d)`` float32)."""
    b, t, d = r.shape
    hd = d // n_heads

    def heads(a):           # (B, T, d) → (B, H, T, N) float32
        return a.reshape(b, t, n_heads, hd).transpose(1, 2).float()

    rh, kh, vh, wh = heads(r), heads(k), heads(v), heads(w)
    bonus = (rh * u[None, :, None, :] * kh).sum(-1, keepdim=True) * vh
    ys = []
    S = S.reshape(b * n_heads, hd, hd)
    for i in range(t):
        ys.append(torch.bmm(rh[:, :, i].reshape(b * n_heads, 1, hd), S))
        S = torch.baddbmm(S * wh[:, :, i].reshape(b * n_heads, hd, 1),
                          kh[:, :, i].reshape(b * n_heads, hd, 1),
                          vh[:, :, i].reshape(b * n_heads, 1, hd))
    y = torch.cat(ys, dim=1).reshape(b, n_heads, t, hd) + bonus
    return S.reshape(b, n_heads, hd, hd), y.transpose(1, 2).reshape(b, t, d)


def wkv_chunked(S: torch.Tensor, r, k, v, lw, u: torch.Tensor, n_heads: int,
                sub: int = _SUB):
    """The recurrence over ``(B, T, d)`` inputs from state ``S``, given the
    log decays ``lw = log w`` (float32), in sub-chunks of ``min(sub, T)``
    tokens (the last padded with identity steps: ``lw = 0``, ``k = v = r =
    0``).  With ``c`` the inclusive cumulative sum of ``lw`` inside a
    sub-chunk and ``c_{-1} = 0``, token ``t`` of a sub-chunk entered with
    state ``S0`` gives::

        y_t = (r_t ⊙ e^{c_{t-1}}) S0 + Σ_{s<t} (Σ_i r_ti k_si e^{c_{t-1,i} - c_si}) v_s
              + (r_t·(u⊙k_t)) v_t

    and the state leaving it is ``e^{c_{L-1}} ⊙ S0 + Σ_s (k_s ⊙
    e^{c_{L-1} - c_s})ᵀ v_s``.  Every exponent is ≤ 0.  Returns (new S,
    y ``(B, T, d)`` float32)."""
    b, t, d = r.shape
    hd = d // n_heads
    size = min(sub, t)
    n = -(-t // size)

    def heads(a):           # (B, T, d) → (B, H, n, L, N) float32, padded with 0
        a = F.pad(a.float(), (0, 0, 0, n * size - t))
        return a.reshape(b, n, size, n_heads, hd).permute(0, 3, 1, 2, 4)

    rh, kh, vh, lwh = heads(r), heads(k), heads(v), heads(lw)
    c = lwh.cumsum(3)
    c_prev = F.pad(c[..., :-1, :], (0, 0, 1, 0))
    below = torch.ones(size, size, dtype=torch.bool, device=r.device).tril(-1)
    pair = torch.where(below[:, :, None], c_prev[..., :, None, :] - c[..., None, :, :],
                       float("-inf")).exp()
    att = (rh[..., :, None, :] * kh[..., None, :, :] * pair).sum(-1)       # (.., L, L)
    bonus = (rh * u[None, :, None, None, :] * kh).sum(-1, keepdim=True) * vh
    into = (kh * (c[..., -1:, :] - c).exp()).transpose(-1, -2) @ vh       # (.., N, N)
    decay = c[..., -1, :, None].exp()                                    # (.., n, N, 1)
    # the states leaving each sub-chunk, S_j = decay_j ⊙ S_{j-1} + into_j
    # from S_{-1} = S, by Hillis-Steele doubling over the sub-chunks (log2(n)
    # levels, as rglru._rglru_scan): a level at offset s composes each
    # position with the one s before it
    out = torch.cat([torch.addcmul(into[:, :, :1], decay[:, :, :1], S[:, :, None]),
                     into[:, :, 1:]], 2)
    step = 1
    while step < n:
        out = torch.cat([out[:, :, :step],
                         torch.addcmul(out[:, :, step:], decay[:, :, step:],
                                       out[:, :, :-step])], 2)
        if 2 * step < n:
            decay = torch.cat([decay[:, :, :step], decay[:, :, step:] * decay[:, :, :-step]], 2)
        step *= 2
    entered = torch.cat([S[:, :, None], out[:, :, :-1]], 2)
    y = att @ vh + (rh * c_prev.exp()) @ entered + bonus
    return out[:, :, -1], y.permute(0, 2, 3, 1, 4).reshape(b, n * size, d)[:, :t]


def _shift(prev: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``[prev, x[:, :-1]]`` along time: each token's predecessor."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def rwkv6_block(x: torch.Tensor, p: RWKV6Block, policy: SparsityPolicy, phase: str,
                n_heads: int, state: Optional[Dict[str, torch.Tensor]] = None,
                layer_idx: Optional[int] = None):
    """``x (B, T, d)`` → (out, new state); ``state`` None: zeros."""
    b, t, d = x.shape
    if state is None:
        state = init_rwkv6_state(b, d, n_heads, x.dtype, x.device)
    tm, cm = p.tm, p.cm

    # ---- time mix ----
    dx = _shift(state["tm_shift"], x) - x
    xr, xk, xv = x + dx * tm.mix_r, x + dx * tm.mix_k, x + dx * tm.mix_v
    xw, xg = x + dx * tm.mix_w, x + dx * tm.mix_g

    def proj(xi, lin, module):
        return sparse_linear(xi, lin, module, policy, phase, layer_idx)

    r = proj(xr, tm.r_proj, "q_proj")
    k = proj(xk, tm.k_proj_tm, "q_proj")
    v = proj(xv, tm.v_proj_tm, "q_proj")
    g = F.silu(proj(xg, tm.g_proj, "q_proj"))
    # the decay w = exp(lw) with lw = -exp(w0 + tanh(x_w A) B), float32
    lw = -torch.exp(tm.w0 + torch.tanh(xw.float() @ tm.w_A.float()) @ tm.w_B.float())

    def wkv(S, r, k, v, lw, u):
        heads = u.shape[0]
        if t == 1:
            S, y = _time_mix_step(S, r[:, 0], k[:, 0], v[:, 0], torch.exp(lw[:, 0]), u, heads)
            return S, y[:, None].to(x.dtype)
        S, y = wkv_chunked(S, r, k, v, lw, u, heads)
        return S, y.to(x.dtype)

    if sharding.model_dim(state["S"]) == 1:
        # a cell's state held on its heads: the rank's heads, the output gathered
        S_new, y = sharding.head_state_local(wkv, state["S"], r, k, v, lw, per_head=(tm.u,))
    else:
        S_new, y = wkv(state["S"], r, k, v, lw, tm.u)
    y = _group_norm(y, tm.ln_x, n_heads) * g
    h = x + proj(y, tm.o_proj, "o_proj")

    # ---- channel mix ----
    dxc = _shift(state["cm_shift"], h) - h
    kk = torch.square(F.relu(proj(h + dxc * cm.mix_k, cm.gate_proj, "gate_proj")))
    kv = proj(kk, cm.down_proj, "down_proj")
    rr = torch.sigmoid(proj(h + dxc * cm.mix_r, cm.up_proj, "up_proj"))
    return h + rr * kv, {"tm_shift": x[:, -1], "cm_shift": h[:, -1], "S": S_new}

"""Transformer-layer kernels of the serving encoder, and their plain versions.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/ops/fused_block.py``:

- :func:`fused_attention_block` (B3a) — ``x + out_proj(attn(LN1(x)))``;
- :func:`fused_mlp_block` (B3b) — ``x + c_proj(QuickGELU(c_fc(LN2(x))))``;
- :func:`fused_layer_q8` (B1) — one whole W8A8 pre-LN layer with dynamic
  per-row int8 activations and per-FF-chunk requantization.

Layout contract as in the JAX package: ``x`` is ``[rows, width]`` with whole
sequences of ``seq_len`` rows stored contiguously, weights are ``[in, out]``.
``mask_len`` hides trailing key positions of each sequence.

A CUDA tensor launches the kernel in ``csrc/fused_block.cu`` (bf16
activations); a CPU tensor runs the plain version below, whose arithmetic
(f32 accumulators, bias added in f32 before the bf16 cast, p cast before
p@v, residual added in the activation dtype) follows the Pallas kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import dispatch
from .dispatch import F, I, P

_LANE = 128


def default_mlp_chunks(ff: int) -> int:
    """Most FF chunks whose size is a multiple of 128 (the JAX rule; the
    q8 requantization groups by these chunks, so the port keeps it)."""
    for c in (8, 6, 4, 3, 2):
        if ff % c == 0 and (ff // c) % _LANE == 0:
            return c
    return 1


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: ``(w_q [K, C] int8, s [1, C] f32)``."""
    w = w.float()
    s = (w.abs().amax(dim=0, keepdim=True) / 127.0).clamp_min(1e-12)
    return torch.round(w / s).to(torch.int8), s


# ---------------------------------------------------------------------------
# Plain versions (the CPU route, and the comparison on the card)
# ---------------------------------------------------------------------------


def _ln_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)) * scale.float() + bias.float()


def _quantize_rows(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic int8 of f32 activations: ``(h_q int8, r [N, 1] f32)``."""
    r = (h.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    return torch.round(h / r).to(torch.int8), r


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 product as f32 (the int32 accumulator cast to f32).
    CUDA matmul has no integer path; float64 is exact there because
    |sum| <= 127^2 * K < 2^53."""
    if a.is_cuda:
        return (a.double() @ b.double()).float()
    return (a.int() @ b.int()).float()


def _q8_matmul(h: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    hq, r = _quantize_rows(h)
    return _int_matmul(hq, wq) * r * ws


def _attention_interior(
    qkv: torch.Tensor, *, seq_len: int, mask_len: int, heads: int, causal: bool, out_dtype
) -> torch.Tensor:
    """[N, 3W] -> [N, W]: per-sequence attention, f32 scores and softmax,
    p cast to the qkv dtype before p@v (f32 accumulation)."""
    n, w3 = qkv.shape
    width = w3 // 3
    hd = width // heads
    q, k, v = qkv.view(n // seq_len, seq_len, 3, heads, hd).permute(2, 0, 3, 1, 4)
    idx = torch.arange(seq_len, device=qkv.device)
    ok = idx[None, :] < mask_len
    if causal:
        ok = ok & (idx[None, :] <= idx[:, None])
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    s = q.float() @ k.float().transpose(-1, -2)
    s = torch.where(ok, s * scale, torch.full_like(s, -1e9))
    s = s - s.amax(-1, keepdim=True)
    e = torch.exp(s)
    p = (e / e.sum(-1, keepdim=True)).to(qkv.dtype)
    o = p.float() @ v.float()  # [nseq, H, S, hd]
    return o.permute(0, 2, 1, 3).reshape(n, width).to(out_dtype)


def attention_block_plain(
    x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, *, seq_len, heads, mask_len, eps, causal
):
    h = _ln_f32(x, ln_scale, ln_bias, eps).to(x.dtype)
    qkv = (h.float() @ wqkv.float() + bqkv.float()).to(x.dtype)
    attn = _attention_interior(
        qkv, seq_len=seq_len, mask_len=mask_len, heads=heads, causal=causal, out_dtype=x.dtype
    )
    out = attn.float() @ wo.float() + bo.float()
    return x + out.to(x.dtype)


def mlp_block_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps):
    h = _ln_f32(x, ln_scale, ln_bias, eps).to(x.dtype)
    f = h.float() @ w1.float() + b1.float()
    f = (f * torch.sigmoid(1.702 * f)).to(x.dtype)
    acc = f.float() @ w2.float()
    return x + (acc + b2.float()).to(x.dtype)


def _attn_half_q8(x, g, c, wqkv_q, wqkv_s, bqkv, wo_q, wo_s, bo, *, seq_len, heads, mask_len, eps, causal):
    h = _ln_f32(x, g, c, eps)
    qkv = (_q8_matmul(h, wqkv_q, wqkv_s) + bqkv.float()).to(x.dtype)
    attn = _attention_interior(
        qkv, seq_len=seq_len, mask_len=mask_len, heads=heads, causal=causal, out_dtype=x.dtype
    )
    out = _q8_matmul(attn.float(), wo_q, wo_s) + bo.float()
    return x + out.to(x.dtype)


def _mlp_half_q8(x, g, c, w1_q, w1_s, b1, w2_q, w2_s, b2, *, n_chunks, eps):
    h = _ln_f32(x, g, c, eps)
    hq, hr = _quantize_rows(h)
    ck = w1_q.shape[1] // n_chunks
    acc = None
    for i in range(n_chunks):
        sl = slice(i * ck, (i + 1) * ck)
        f = _int_matmul(hq, w1_q[:, sl]) * hr * w1_s[:, sl]
        f = f + b1.float()[sl]
        f = f * torch.sigmoid(1.702 * f)
        fq, fr = _quantize_rows(f)
        part = _int_matmul(fq, w2_q[sl, :]) * fr * w2_s
        acc = part if acc is None else acc + part
    return x + (acc + b2.float()).to(x.dtype)


def layer_q8_plain(
    x, ln1_scale, ln1_bias, wqkv_q, wqkv_s, bqkv, wo_q, wo_s, bo,
    ln2_scale, ln2_bias, w1_q, w1_s, b1, w2_q, w2_s, b2,
    *, seq_len, heads, mask_len, n_chunks, eps, causal,
):
    y = _attn_half_q8(
        x, ln1_scale, ln1_bias, wqkv_q, wqkv_s, bqkv, wo_q, wo_s, bo,
        seq_len=seq_len, heads=heads, mask_len=mask_len, eps=eps, causal=causal,
    )
    return _mlp_half_q8(
        y, ln2_scale, ln2_bias, w1_q, w1_s, b1, w2_q, w2_s, b2, n_chunks=n_chunks, eps=eps
    )


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_layout(x: torch.Tensor, width: int, seq_len: int, heads: int) -> None:
    if x.ndim != 2 or x.shape[1] != width:
        raise ValueError(f"x must be [rows, {width}], got {tuple(x.shape)}")
    if x.shape[0] % seq_len:
        raise ValueError(f"rows {x.shape[0]} are not whole sequences of {seq_len}")
    if width % heads or (width // heads) % 2:
        raise ValueError(f"width {width} not divisible into {heads} even heads")


def _check_ff(ff: int, n_chunks: int) -> None:
    if ff % n_chunks or (ff // n_chunks) % _LANE:
        raise ValueError(f"ff {ff} must split into {n_chunks} chunks of a multiple of {_LANE}")


_ATTN_ARGS = [P] * 11 + [I] * 6 + [F, P]
_MLP_ARGS = [P] * 10 + [I] * 3 + [F, P]
_LAYER_Q8_ARGS = [P] * 27 + [I] * 8 + [F, P]


@dispatch.counted
def fused_attention_block(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    *,
    seq_len: int,
    heads: int,
    mask_len: Optional[int] = None,
    eps: float = 1e-5,
    causal: bool = True,
) -> torch.Tensor:
    """B3a: ``x + out_proj(attention(LN(x)))``; causal for the text tower."""
    width = wqkv.shape[0]
    _check_layout(x, width, seq_len, heads)
    mask_len = seq_len if mask_len is None else mask_len
    if not dispatch.use_kernel(x):
        return attention_block_plain(
            x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, seq_len=seq_len, heads=heads,
            mask_len=mask_len, eps=eps, causal=causal,
        )
    n, dev, bf = x.shape[0], x.device, torch.bfloat16
    for name, t, dt, shape in (
        ("x", x, bf, None), ("ln_scale", ln_scale, torch.float32, (width,)),
        ("ln_bias", ln_bias, torch.float32, (width,)), ("wqkv", wqkv, bf, (width, 3 * width)),
        ("bqkv", bqkv, torch.float32, (3 * width,)), ("wo", wo, bf, (width, width)),
        ("bo", bo, torch.float32, (width,)),
    ):
        dispatch.require(t, name, dt, dev, shape)
    out = torch.empty_like(x)
    h = torch.empty_like(x)
    qkv = torch.empty((n, 3 * width), dtype=bf, device=dev)
    attn = torch.empty_like(x)
    fn = dispatch.kernel("kemr_attention_block_bf16", _ATTN_ARGS)
    status = fn(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
        wo.data_ptr(), bo.data_ptr(), out.data_ptr(), h.data_ptr(), qkv.data_ptr(),
        attn.data_ptr(), n, width, heads, seq_len, mask_len, int(causal), eps,
        dispatch.stream_of(x),
    )
    dispatch.check(status, "fused_attention_block")
    fused_attention_block.launches += 1
    return out


@dispatch.counted
def fused_mlp_block(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """B3b: ``x + c_proj(quick_gelu(c_fc(LN(x))))`` with an f32 accumulator."""
    width, ff = w1.shape
    if x.ndim != 2 or x.shape[1] != width:
        raise ValueError(f"x must be [rows, {width}], got {tuple(x.shape)}")
    if not dispatch.use_kernel(x):
        return mlp_block_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps)
    n, dev, bf = x.shape[0], x.device, torch.bfloat16
    for name, t, dt, shape in (
        ("x", x, bf, None), ("ln_scale", ln_scale, torch.float32, (width,)),
        ("ln_bias", ln_bias, torch.float32, (width,)), ("w1", w1, bf, (width, ff)),
        ("b1", b1, torch.float32, (ff,)), ("w2", w2, bf, (ff, width)),
        ("b2", b2, torch.float32, (width,)),
    ):
        dispatch.require(t, name, dt, dev, shape)
    out = torch.empty_like(x)
    h = torch.empty_like(x)
    f = torch.empty((n, ff), dtype=bf, device=dev)
    fn = dispatch.kernel("kemr_mlp_block_bf16", _MLP_ARGS)
    status = fn(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), h.data_ptr(), f.data_ptr(),
        n, width, ff, eps, dispatch.stream_of(x),
    )
    dispatch.check(status, "fused_mlp_block")
    fused_mlp_block.launches += 1
    return out


@dispatch.counted
def fused_layer_q8(
    x: torch.Tensor,
    ln1_scale: torch.Tensor,
    ln1_bias: torch.Tensor,
    wqkv_q: torch.Tensor,
    wqkv_s: torch.Tensor,
    bqkv: torch.Tensor,
    wo_q: torch.Tensor,
    wo_s: torch.Tensor,
    bo: torch.Tensor,
    ln2_scale: torch.Tensor,
    ln2_bias: torch.Tensor,
    w1_q: torch.Tensor,
    w1_s: torch.Tensor,
    b1: torch.Tensor,
    w2_q: torch.Tensor,
    w2_s: torch.Tensor,
    b2: torch.Tensor,
    *,
    seq_len: int,
    heads: int,
    mask_len: Optional[int] = None,
    n_chunks: Optional[int] = None,
    eps: float = 1e-5,
    causal: bool = True,
) -> torch.Tensor:
    """B1: a whole W8A8 residual layer (attention half, then MLP half).

    Weights are per-output-channel int8 with f32 scales ``[1, C]``
    (:func:`quantize_weight`); activations are quantized per row after each
    LayerNorm, before the out-projection, and per FF chunk after QuickGELU."""
    width = wqkv_q.shape[0]
    ff = w1_q.shape[1]
    _check_layout(x, width, seq_len, heads)
    mask_len = seq_len if mask_len is None else mask_len
    n_chunks = default_mlp_chunks(ff) if n_chunks is None else n_chunks
    _check_ff(ff, n_chunks)
    args = (x, ln1_scale, ln1_bias, wqkv_q, wqkv_s, bqkv, wo_q, wo_s, bo,
            ln2_scale, ln2_bias, w1_q, w1_s, b1, w2_q, w2_s, b2)
    if not dispatch.use_kernel(x):
        return layer_q8_plain(
            *args, seq_len=seq_len, heads=heads, mask_len=mask_len, n_chunks=n_chunks,
            eps=eps, causal=causal,
        )
    n, dev = x.shape[0], x.device
    f32, i8, bf = torch.float32, torch.int8, torch.bfloat16
    specs = (
        ("x", bf, None), ("ln1_scale", f32, (width,)), ("ln1_bias", f32, (width,)),
        ("wqkv_q", i8, (width, 3 * width)), ("wqkv_s", f32, (1, 3 * width)),
        ("bqkv", f32, (3 * width,)), ("wo_q", i8, (width, width)), ("wo_s", f32, (1, width)),
        ("bo", f32, (width,)), ("ln2_scale", f32, (width,)), ("ln2_bias", f32, (width,)),
        ("w1_q", i8, (width, ff)), ("w1_s", f32, (1, ff)), ("b1", f32, (ff,)),
        ("w2_q", i8, (ff, width)), ("w2_s", f32, (1, width)), ("b2", f32, (width,)),
    )
    for t, (name, dt, shape) in zip(args, specs):
        dispatch.require(t, name, dt, dev, shape)
    ck = ff // n_chunks
    out = torch.empty_like(x)
    scratch = (
        torch.empty((n, width), dtype=i8, device=dev),  # hq
        torch.empty((n,), dtype=f32, device=dev),  # hr
        torch.empty((n, 3 * width), dtype=bf, device=dev),  # qkv
        torch.empty((n, width), dtype=bf, device=dev),  # attn
        torch.empty((n, width), dtype=bf, device=dev),  # y
        torch.empty((n, ck), dtype=f32, device=dev),  # fbuf
        torch.empty((n, ck), dtype=i8, device=dev),  # fq
        torch.empty((n,), dtype=f32, device=dev),  # fr
        torch.empty((n, width), dtype=f32, device=dev),  # acc
    )
    fn = dispatch.kernel("kemr_layer_q8", _LAYER_Q8_ARGS)
    status = fn(
        *[t.data_ptr() for t in args], out.data_ptr(), *[t.data_ptr() for t in scratch],
        n, width, ff, heads, seq_len, mask_len, n_chunks, int(causal), eps,
        dispatch.stream_of(x),
    )
    dispatch.check(status, "fused_layer_q8")
    fused_layer_q8.launches += 1
    return out

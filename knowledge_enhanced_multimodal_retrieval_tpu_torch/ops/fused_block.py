"""Transformer-layer kernels of the serving encoder, and their plain versions.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/ops/fused_block.py``:

- :func:`fused_attention_block` (B3a) — ``x + out_proj(attn(LN1(x)))``;
- :func:`fused_mlp_block` (B3b) — ``x + c_proj(QuickGELU(c_fc(LN2(x))))``;
- :func:`fused_layer_q8` (B1) — one whole W8A8 pre-LN layer with dynamic
  per-row int8 activations and per-FF-chunk requantization;
- :func:`fused_attention_block_q8` (B4a) and :func:`fused_mlp_block_q8`
  (B4b) — B1's two halves, each as its own launch. The pair and the whole
  layer share one body on either route (``_attn_half_q8`` / ``_mlp_half_q8``
  here, ``attn_half_q8`` / ``mlp_half_q8`` in the CUDA source), so
  ``B4b(B4a(x))`` equals ``B1(x)`` bit for bit.

Layout contract as in the JAX package: ``x`` is ``[rows, width]`` with whole
sequences of ``seq_len`` rows stored contiguously, weights are ``[in, out]``.
``mask_len`` hides trailing key positions of each sequence.

The int8 kernels' GEMM reads each int8 weight K-major, as an ``[out, in]``
copy (:func:`k_major`): the tensor cores' 8-bit operands cannot be read
transposed. A packed plan keeps the copies (``models.fast_encode``) and hands
them in as ``*_qt``; a caller with only the ``[in, out]`` weights leaves them
out and the wrapper makes them for the call. The plain versions read only
``[in, out]``.

The attention interior between the projections (``_attention_interior``)
is one device function behind B3a, B1, B4a and S1: ``wgmma`` on K/V tiles that
TMA brings in where the head dim is 64 (``csrc/attention_interior.cuh``), one
warp per query row otherwise; :func:`attention_interior` runs it alone and
:func:`attention_route_counts` says which route the calls took.

A CUDA tensor launches the kernel in ``csrc/fused_block.cu`` (bf16
activations); a CPU tensor runs the plain version below, whose arithmetic
(f32 accumulators, bias added in f32 before the bf16 cast, p cast before
p@v, residual added in the activation dtype) follows the Pallas kernels.
"""

from __future__ import annotations

import ctypes
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


def k_major(w_q: torch.Tensor) -> torch.Tensor:
    """The ``[out, in]`` copy of an ``[in, out]`` int8 weight that the int8
    kernels' GEMM reads (its exact transpose, contiguous)."""
    return w_q.t().contiguous()


def _k_major_operands(weights, copies, names):
    """The kernels' ``[out, in]`` operands: each given copy checked against
    its ``[in, out]`` weight's shape, each missing one made here."""
    out = []
    for w, wt, name in zip(weights, copies, names):
        if wt is None:
            wt = k_major(w)
        else:
            dispatch.require(wt, name, torch.int8, w.device, (w.shape[1], w.shape[0]))
        out.append(wt)
    return out


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
    qkv: torch.Tensor, *, seq_len: int, mask_len: int, heads: int, causal: bool, out_dtype,
    subtract_max: bool = True,
) -> torch.Tensor:
    """[N, 3W] -> [N, W]: per-sequence attention, f32 scores and softmax,
    p cast to the qkv dtype before p@v (f32 accumulation).
    ``subtract_max=False`` is the vision profiler's diagnostic interior: the
    same order of operations without the row-max pass."""
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
    if subtract_max:
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


def _attn_half_q8(
    x, g, c, wqkv_q, wqkv_s, bqkv, wo_q, wo_s, bo, *, seq_len, heads, mask_len, eps, causal,
    subtract_max=True,
):
    h = _ln_f32(x, g, c, eps)
    qkv = (_q8_matmul(h, wqkv_q, wqkv_s) + bqkv.float()).to(x.dtype)
    attn = _attention_interior(
        qkv, seq_len=seq_len, mask_len=mask_len, heads=heads, causal=causal, out_dtype=x.dtype,
        subtract_max=subtract_max,
    )
    out = _q8_matmul(attn.float(), wo_q, wo_s) + bo.float()
    return x + out.to(x.dtype)


def _mlp_half_q8(x, g, c, w1_q, w1_s, b1, w2_q, w2_s, b2, *, n_chunks, eps, gelu=True, requant=True):
    """``gelu=False`` / ``requant=False`` are the vision profiler's
    diagnostics: no QuickGELU; and f cast to bf16 times the int8 c_proj chunk
    cast to bf16 (exact), f32 accumulation, scaled by ``w2_s`` after the
    product, with no activation quantization."""
    h = _ln_f32(x, g, c, eps)
    hq, hr = _quantize_rows(h)
    ck = w1_q.shape[1] // n_chunks
    acc = None
    for i in range(n_chunks):
        sl = slice(i * ck, (i + 1) * ck)
        f = _int_matmul(hq, w1_q[:, sl]) * hr * w1_s[:, sl]
        f = f + b1.float()[sl]
        if gelu:
            f = f * torch.sigmoid(1.702 * f)
        if requant:
            fq, fr = _quantize_rows(f)
            part = _int_matmul(fq, w2_q[sl, :]) * fr * w2_s
        else:
            part = (f.to(torch.bfloat16).float() @ w2_q[sl, :].float()) * w2_s
        acc = part if acc is None else acc + part
    return x + (acc + b2.float()).to(x.dtype)


def attention_block_q8_plain(
    x, ln_scale, ln_bias, wqkv_q, wqkv_s, bqkv, wo_q, wo_s, bo, *, seq_len, heads, mask_len, eps, causal
):
    """B4a's plain version: the attention half of :func:`layer_q8_plain`."""
    return _attn_half_q8(
        x, ln_scale, ln_bias, wqkv_q, wqkv_s, bqkv, wo_q, wo_s, bo,
        seq_len=seq_len, heads=heads, mask_len=mask_len, eps=eps, causal=causal,
    )


def mlp_block_q8_plain(x, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2, *, n_chunks, eps):
    """B4b's plain version: the MLP half of :func:`layer_q8_plain`."""
    return _mlp_half_q8(x, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2, n_chunks=n_chunks, eps=eps)


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
_LAYER_Q8_ARGS = [P] * 31 + [I] * 8 + [F, P]
_ATTN_Q8_ARGS = [P] * 16 + [I] * 6 + [F, P]
_MLP_Q8_ARGS = [P] * 18 + [I] * 4 + [F, P]


def _attn_q8_specs(width: int, n: str = ""):
    """(name, dtype, shape) of the q8 attention half's operands after ``x``."""
    f32, i8 = torch.float32, torch.int8
    return (
        (f"ln{n}_scale", f32, (width,)), (f"ln{n}_bias", f32, (width,)),
        ("wqkv_q", i8, (width, 3 * width)), ("wqkv_s", f32, (1, 3 * width)),
        ("bqkv", f32, (3 * width,)), ("wo_q", i8, (width, width)), ("wo_s", f32, (1, width)),
        ("bo", f32, (width,)),
    )


def _mlp_q8_specs(width: int, ff: int, n: str = ""):
    """(name, dtype, shape) of the q8 MLP half's operands after ``x``."""
    f32, i8 = torch.float32, torch.int8
    return (
        (f"ln{n}_scale", f32, (width,)), (f"ln{n}_bias", f32, (width,)),
        ("w1_q", i8, (width, ff)), ("w1_s", f32, (1, ff)), ("b1", f32, (ff,)),
        ("w2_q", i8, (ff, width)), ("w2_s", f32, (1, width)), ("b2", f32, (width,)),
    )


def _require_all(args, specs) -> None:
    """``x`` (bf16, any shape already checked) then one operand per spec,
    all on ``x``'s device."""
    dispatch.require(args[0], "x", torch.bfloat16, args[0].device)
    for t, (name, dt, shape) in zip(args[1:], specs):
        dispatch.require(t, name, dt, args[0].device, shape)


def _row_quant_scratch(x: torch.Tensor):
    """hq int8 [N, W] and hr f32 [N]: the quantized rows a half projects."""
    n, width = x.shape
    return (
        torch.empty((n, width), dtype=torch.int8, device=x.device),
        torch.empty((n,), dtype=torch.float32, device=x.device),
    )


def _attn_q8_scratch(x: torch.Tensor):
    """qkv and attn of the q8 attention half."""
    n, width = x.shape
    return (
        torch.empty((n, 3 * width), dtype=torch.bfloat16, device=x.device),
        torch.empty((n, width), dtype=torch.bfloat16, device=x.device),
    )


def _mlp_q8_scratch(x: torch.Tensor, ff: int, n_chunks: int):
    """fbuf (one FF chunk of f in f32), fq and fr (every chunk's int8 rows
    and row scales: the chunked c_proj reads them in one launch), acc."""
    n, width = x.shape
    f32, dev = torch.float32, x.device
    return (
        torch.empty((n, ff // n_chunks), dtype=f32, device=dev),
        torch.empty((n, ff), dtype=torch.int8, device=dev),
        torch.empty((n_chunks, n), dtype=f32, device=dev),
        torch.empty((n, width), dtype=f32, device=dev),
    )


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
    dispatch.count_launch(fused_attention_block)
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
    dispatch.count_launch(fused_mlp_block)
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
    wqkv_qt: Optional[torch.Tensor] = None,
    wo_qt: Optional[torch.Tensor] = None,
    w1_qt: Optional[torch.Tensor] = None,
    w2_qt: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B1: a whole W8A8 residual layer (attention half, then MLP half).

    Weights are per-output-channel int8 with f32 scales ``[1, C]``
    (:func:`quantize_weight`); activations are quantized per row after each
    LayerNorm, before the out-projection, and per FF chunk after QuickGELU.
    ``*_qt`` are the weights' :func:`k_major` copies (made here when absent)."""
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
    _require_all(args, _attn_q8_specs(width, "1") + _mlp_q8_specs(width, ff, "2"))
    kt = _k_major_operands(
        (wqkv_q, wo_q, w1_q, w2_q), (wqkv_qt, wo_qt, w1_qt, w2_qt), ("wqkv_qt", "wo_qt", "w1_qt", "w2_qt")
    )
    n = x.shape[0]
    out = torch.empty_like(x)
    y = torch.empty_like(x)  # after the attention half
    scratch = (*_row_quant_scratch(x), *_attn_q8_scratch(x), y, *_mlp_q8_scratch(x, ff, n_chunks))
    fn = dispatch.kernel("kemr_layer_q8", _LAYER_Q8_ARGS)
    status = fn(
        *[t.data_ptr() for t in (*args, *kt)], out.data_ptr(), *[t.data_ptr() for t in scratch],
        n, width, ff, heads, seq_len, mask_len, n_chunks, int(causal), eps,
        dispatch.stream_of(x),
    )
    dispatch.check(status, "fused_layer_q8")
    dispatch.count_launch(fused_layer_q8)
    return out


@dispatch.counted
def fused_attention_block_q8(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    wqkv_q: torch.Tensor,
    wqkv_s: torch.Tensor,
    bqkv: torch.Tensor,
    wo_q: torch.Tensor,
    wo_s: torch.Tensor,
    bo: torch.Tensor,
    *,
    seq_len: int,
    heads: int,
    mask_len: Optional[int] = None,
    eps: float = 1e-5,
    causal: bool = True,
    wqkv_qt: Optional[torch.Tensor] = None,
    wo_qt: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B4a: B1's attention half as one launch,
    ``x + out_proj_q8(attention(qkv_q8(LN(x))))``."""
    width = wqkv_q.shape[0]
    _check_layout(x, width, seq_len, heads)
    mask_len = seq_len if mask_len is None else mask_len
    args = (x, ln_scale, ln_bias, wqkv_q, wqkv_s, bqkv, wo_q, wo_s, bo)
    if not dispatch.use_kernel(x):
        return attention_block_q8_plain(
            *args, seq_len=seq_len, heads=heads, mask_len=mask_len, eps=eps, causal=causal
        )
    _require_all(args, _attn_q8_specs(width))
    kt = _k_major_operands((wqkv_q, wo_q), (wqkv_qt, wo_qt), ("wqkv_qt", "wo_qt"))
    out = torch.empty_like(x)
    scratch = (*_row_quant_scratch(x), *_attn_q8_scratch(x))
    fn = dispatch.kernel("kemr_attention_block_q8", _ATTN_Q8_ARGS)
    status = fn(
        *[t.data_ptr() for t in (*args, *kt)], out.data_ptr(), *[t.data_ptr() for t in scratch],
        x.shape[0], width, heads, seq_len, mask_len, int(causal), eps, dispatch.stream_of(x),
    )
    dispatch.check(status, "fused_attention_block_q8")
    dispatch.count_launch(fused_attention_block_q8)
    return out


@dispatch.counted
def fused_mlp_block_q8(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1_q: torch.Tensor,
    w1_s: torch.Tensor,
    b1: torch.Tensor,
    w2_q: torch.Tensor,
    w2_s: torch.Tensor,
    b2: torch.Tensor,
    *,
    n_chunks: Optional[int] = None,
    eps: float = 1e-5,
    w1_qt: Optional[torch.Tensor] = None,
    w2_qt: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B4b: B1's MLP half as one launch,
    ``x + c_proj_q8(quick_gelu(c_fc_q8(LN(x))))`` with the activations
    requantized per FF chunk and an f32 accumulator over the chunks."""
    width, ff = w1_q.shape
    if x.ndim != 2 or x.shape[1] != width:
        raise ValueError(f"x must be [rows, {width}], got {tuple(x.shape)}")
    n_chunks = default_mlp_chunks(ff) if n_chunks is None else n_chunks
    _check_ff(ff, n_chunks)
    args = (x, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2)
    if not dispatch.use_kernel(x):
        return mlp_block_q8_plain(*args, n_chunks=n_chunks, eps=eps)
    _require_all(args, _mlp_q8_specs(width, ff))
    kt = _k_major_operands((w1_q, w2_q), (w1_qt, w2_qt), ("w1_qt", "w2_qt"))
    out = torch.empty_like(x)
    scratch = (*_row_quant_scratch(x), *_mlp_q8_scratch(x, ff, n_chunks))
    fn = dispatch.kernel("kemr_mlp_block_q8", _MLP_Q8_ARGS)
    status = fn(
        *[t.data_ptr() for t in (*args, *kt)], out.data_ptr(), *[t.data_ptr() for t in scratch],
        x.shape[0], width, ff, n_chunks, eps, dispatch.stream_of(x),
    )
    dispatch.check(status, "fused_mlp_block_q8")
    dispatch.count_launch(fused_mlp_block_q8)
    return out


# ---------------------------------------------------------------------------
# The attention interior on its own (tests and yardsticks at shapes no layer has)
# ---------------------------------------------------------------------------

_INTERIOR_ARGS = [P] * 2 + [I] * 7 + [P]


def attention_interior(
    qkv: torch.Tensor,
    *,
    seq_len: int,
    heads: int,
    mask_len: Optional[int] = None,
    causal: bool = True,
    subtract_max: bool = True,
) -> torch.Tensor:
    """The attention interior of B3a, B1, B4a and S1 alone: ``qkv [N, 3W]``
    (whole sequences of ``seq_len`` rows) to ``[N, W]``, as the layer kernels
    run it (see :func:`_attention_interior` for what it computes).
    ``subtract_max=False`` is S1's no-max interior. A CUDA tensor (bf16)
    launches the kernel, on the wgmma route when the head dim is 64 and the
    buffers are 16-byte aligned, else on the one-warp-per-row route."""
    if qkv.ndim != 2 or qkv.shape[1] % 3:
        raise ValueError(f"qkv must be [rows, 3 * width], got {tuple(qkv.shape)}")
    width = qkv.shape[1] // 3
    _check_layout(qkv[:, :width], width, seq_len, heads)
    mask_len = seq_len if mask_len is None else mask_len
    if not dispatch.use_kernel(qkv):
        return _attention_interior(
            qkv, seq_len=seq_len, mask_len=mask_len, heads=heads, causal=causal, out_dtype=qkv.dtype,
            subtract_max=subtract_max,
        )
    dispatch.require(qkv, "qkv", torch.bfloat16, qkv.device)
    out = torch.empty((qkv.shape[0], width), dtype=torch.bfloat16, device=qkv.device)
    fn = dispatch.kernel("kemr_attention_interior", _INTERIOR_ARGS)
    status = fn(
        qkv.data_ptr(), out.data_ptr(), qkv.shape[0], width, heads, seq_len, mask_len, int(causal),
        int(not subtract_max), dispatch.stream_of(qkv),
    )
    dispatch.check(status, "attention_interior")
    return out


def force_row_attention(on: bool) -> None:
    """Send every attention interior of the layer kernels to the
    one-warp-per-row route (``True``) or let shape and alignment choose
    (``False``, the rule). For comparing the two routes on the card; the
    library is built if it was not."""
    fn = dispatch.library().kemr_attention_force_rows
    fn.argtypes, fn.restype = [I], None
    fn(int(bool(on)))


def attention_route_counts() -> Tuple[int, int]:
    """Attention interiors the layer kernels have launched so far on the
    wgmma + TMA route and on the one-warp-per-row route (which a shape takes
    when its head dim is not 64 or its buffers are not 16-byte aligned)."""
    fn = dispatch.library().kemr_attention_route_count
    fn.argtypes, fn.restype = [I], ctypes.c_longlong
    return int(fn(0)), int(fn(1))


# ---------------------------------------------------------------------------
# The layer kernels' GEMM on its own (tests at shapes no layer has)
# ---------------------------------------------------------------------------

# The epilogues of ``csrc/fused_block.cu`` by their values there.
EPI_BIAS_BF16, EPI_BIAS_RES_BF16, EPI_BIAS_GELU_BF16, EPI_BIAS_GELU_F32 = 0, 1, 2, 3
EPI_ACC_F32, EPI_BIAS_F32, EPI_SCALE_ACC_F32 = 4, 5, 6
_EPI_INT8 = (EPI_BIAS_BF16, EPI_BIAS_RES_BF16, EPI_BIAS_GELU_BF16, EPI_BIAS_GELU_F32, EPI_ACC_F32, EPI_BIAS_F32)
_EPI_BF16 = (EPI_BIAS_BF16, EPI_BIAS_RES_BF16, EPI_BIAS_GELU_BF16, EPI_SCALE_ACC_F32)
_GEMM_ARGS = [P] * 9 + [I] * 7 + [P]


def force_wmma_gemm(on: bool) -> None:
    """Send every GEMM of the layer kernels to the WMMA route (``True``) or
    let shape and alignment choose (``False``, the rule). For comparing the
    two routes on the card; the library is built if it was not."""
    fn = dispatch.library().kemr_gemm_force_wmma
    fn.argtypes, fn.restype = [I], None
    fn(int(bool(on)))


def gemm_route_counts() -> Tuple[int, int]:
    """GEMMs the layer kernels have launched so far on the wgmma + TMA route
    and on the WMMA route (which a shape takes when TMA cannot describe it)."""
    fn = dispatch.library().kemr_gemm_route_count
    fn.argtypes, fn.restype = [I], ctypes.c_longlong
    return int(fn(0)), int(fn(1))


def _quick_gelu(f: torch.Tensor) -> torch.Tensor:
    return f * torch.sigmoid(1.702 * f)


def gemm_epilogue_plain(a, b, epi, *, bias, row_scale=None, col_scale=None, res=None, acc=None, last=True):
    """Plain version of one GEMM of the layer kernels with one epilogue:
    ``a [M, K] @ b [K, N]`` in bf16 (f32 sums) or int8 (exact sums, times
    ``row_scale [M]`` and ``col_scale [N]``). Returns bf16 ``[M, N]``, or f32
    for ``EPI_*_F32`` and for an accumulating epilogue that is not ``last``
    (``acc`` is the f32 sum of the chunks before, ``None`` on the first)."""
    if a.dtype == torch.int8:
        v = _int_matmul(a, b) * row_scale.reshape(-1, 1) * col_scale.reshape(1, -1)
    else:
        v = a.float() @ b.float()
        if epi == EPI_SCALE_ACC_F32:
            v = v * col_scale.reshape(1, -1)
    if epi in (EPI_ACC_F32, EPI_SCALE_ACC_F32):
        v = v if acc is None else acc + v
        return res + (v + bias).to(torch.bfloat16) if last else v
    v = v + bias
    if epi in (EPI_BIAS_GELU_BF16, EPI_BIAS_GELU_F32):
        v = _quick_gelu(v)
    if epi in (EPI_BIAS_GELU_F32, EPI_BIAS_F32):
        return v
    v = v.to(torch.bfloat16)
    return res + v if epi == EPI_BIAS_RES_BF16 else v


def gemm_epilogue(a, b, epi, *, bias, row_scale=None, col_scale=None, res=None, acc=None, last=True):
    """One GEMM of the layer kernels with one epilogue, as the kernels run
    it (see :func:`gemm_epilogue_plain` for what it computes). ``b`` is the
    ``[K, N]`` weight; an int8 ``b`` is also handed over K-major. An f32
    ``acc`` is updated in place and returned when the epilogue is not
    ``last``."""
    if not dispatch.use_kernel(a):
        return gemm_epilogue_plain(a, b, epi, bias=bias, row_scale=row_scale, col_scale=col_scale, res=res,
                                   acc=acc, last=last)
    is_int8 = a.dtype == torch.int8
    if epi not in (_EPI_INT8 if is_int8 else _EPI_BF16):
        raise ValueError(f"epilogue {epi} does not go with {a.dtype} operands")
    (m, k), n, dev, f32, bf = a.shape, b.shape[1], a.device, torch.float32, torch.bfloat16
    dispatch.require(a, "a", torch.int8 if is_int8 else bf, dev)
    dispatch.require(b, "b", a.dtype, dev, (k, n))
    dispatch.require(bias, "bias", f32, dev, (n,))
    if is_int8:
        dispatch.require(row_scale, "row_scale", f32, dev, (m,))
    if is_int8 or epi == EPI_SCALE_ACC_F32:
        dispatch.require(col_scale, "col_scale", f32, dev, (n,))
    accumulates = epi in (EPI_ACC_F32, EPI_SCALE_ACC_F32)
    if epi == EPI_BIAS_RES_BF16 or (accumulates and last):
        dispatch.require(res, "res", bf, dev, (m, n))
    f32_out = epi in (EPI_BIAS_GELU_F32, EPI_BIAS_F32) or (accumulates and not last)
    if accumulates and acc is not None:
        dispatch.require(acc, "acc", f32, dev, (m, n))
        out_f32 = acc
    else:
        out_f32 = torch.empty((m, n), dtype=f32, device=dev) if (f32_out or accumulates) else None
    out = None if f32_out else torch.empty((m, n), dtype=bf, device=dev)
    bt = k_major(b) if is_int8 else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = dispatch.kernel("kemr_gemm_epilogue", _GEMM_ARGS)
    status = fn(
        a.data_ptr(), b.data_ptr(), ptr(bt), bias.data_ptr(), ptr(row_scale), ptr(col_scale), ptr(res), ptr(out),
        ptr(out_f32), m, n, k, int(is_int8), epi, int(acc is None), int(bool(last)), dispatch.stream_of(a),
    )
    dispatch.check(status, "gemm_epilogue")
    return out_f32 if f32_out else out

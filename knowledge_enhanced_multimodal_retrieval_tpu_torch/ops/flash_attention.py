"""Tiled online-softmax attention: the kernel behind ``mha`` on every CUDA tensor (both towers).

Counterpart of two Pallas TPU kernels of the JAX package that compute one
function on ``[B, H, S, D]``:

- ``ops/short_attention.py::short_attention`` (B6, 128 < s <= 512);
- ``ops/flash_attention.py::flash_attention`` (B7, s > 512).

The short/flash split sized the sequence to the TPU's VMEM; on Hopper one
kernel (``csrc/attention.cu``) streams K/V tiles through shared memory for
every length: on the tensor cores for bf16 inputs (p rounded to bf16 before
p@v, as ``mha_plain`` and the JAX ``mha_xla`` do), on the CUDA cores in f32
for f32 inputs. :func:`flash_attention` launches it on CUDA tensors and runs
:func:`flash_attention_plain` on CPU tensors. The gradient recomputes
through ``ops.attention.mha_plain``, as both JAX ``_bwd`` rules recompute
through ``mha_xla``, so there is no backward kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dispatch
from .dispatch import F, I, P

_NEG_INF = float(np.finfo(np.float32).min)
MAX_HEAD_DIM = 256  # head dims the kernel takes (its tiles pad to 64, 128 or 256; 32 too in f32)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FLASH_ARGS = [I] + [P] * 4 + [I] * 5 + [F, P]


def _scale(d: int) -> float:
    return 1.0 / (d**0.5)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """The kernel's arithmetic on ``[B, H, S, D]``: q/k/v as f32, scores
    scaled after the dot, masked scores at f32 min with p = 0 there, a zero
    denominator replaced by 1, one cast to the input dtype. For f32 inputs p
    stays f32 through p@v, as in the Pallas kernels. For bf16 inputs the
    unnormalized p = exp(s - max) is rounded to bf16 before p@v (the tensor
    cores take bf16), the sum is taken from the f32 p, and the division comes
    after the product. (The Pallas kernels also mask the columns they pad
    the sequence with; unpadded, there are none.)"""
    sq, sk = q.shape[-2], k.shape[-2]
    s = (q.float() @ k.float().transpose(-1, -2)) * _scale(q.shape[-1])
    if causal:
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        keep = col <= row
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    if causal:
        p = torch.where(keep, p, torch.zeros_like(p))
    denom = p.sum(-1, keepdim=True)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    if q.dtype == torch.bfloat16:
        return ((p.to(torch.bfloat16).float() @ v.float()) / denom).to(q.dtype)
    return ((p / denom) @ v.float()).to(q.dtype)


@dispatch.counted
def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """Launch ``kemr_flash_attention`` on contiguous CUDA ``[B, H, S, D]`` tensors."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dev, dt = q.device, q.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"flash attention takes float32 or bfloat16, got {dt}")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside 1..{MAX_HEAD_DIM}")
    dispatch.require(q, "q", dt, dev, (b, h, sq, d))
    dispatch.require(k, "k", dt, dev, (b, h, sk, d))
    dispatch.require(v, "v", dt, dev, (b, h, sk, d))
    out = torch.empty_like(q)
    fn = dispatch.kernel("kemr_flash_attention", _FLASH_ARGS)
    status = fn(
        _DTYPE_CODE[dt], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b * h, sq, sk, d, int(causal), _scale(d), dispatch.stream_of(q),
    )
    dispatch.check(status, "flash_attention_kernel")
    dispatch.count_launch(flash_attention_kernel)
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        if not dispatch.use_kernel(q):
            return flash_attention_plain(q, k, v, causal)
        return flash_attention_kernel(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        from .attention import mha_plain

        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = mha_plain(*qkv, causal=ctx.causal)
            grads = torch.autograd.grad(out, qkv, g)
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Attention on ``[B, H, S, D]`` -> ``[B, H, S, D]`` in the input dtype;
    differentiable (backward by recompute through ``mha_plain``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    # no graph to record: skip the autograd wrapper (tens of microseconds a call)
    if not dispatch.use_kernel(q):
        return flash_attention_plain(q, k, v, causal)
    return flash_attention_kernel(q, k, v, causal)

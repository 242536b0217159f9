"""Multi-head attention: the plain version and the dispatching ``mha``.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/ops/attention.py``:

- :func:`mha_plain` follows ``mha_xla`` (the dot in the input dtype, f32
  logits scaled after it, f32-min causal mask, f32 softmax, p cast to the
  input dtype before p@v);
- :func:`mha` follows the JAX routing rule, with "on a TPU" read as "a CUDA
  tensor": ``head_dim <= 256`` and ``s > 128`` launch the hand-written
  kernel (:func:`..ops.flash_attention.flash_attention`, the port of B6 and
  B7); anything else runs :func:`mha_plain`, as the JAX package runs XLA
  there (the CPU, the text tower's 77 tokens).
"""

from __future__ import annotations

import torch

from .flash_attention import MAX_HEAD_DIM, flash_attention

_MIN_KERNEL_SEQ = 128  # below this the JAX package measured XLA as faster


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Scaled dot-product attention on ``[B, H, S, D]``."""
    s_q, d = q.shape[-2], q.shape[-1]
    s_k = k.shape[-2]
    logits = (q @ k.transpose(-1, -2)).float() * (1.0 / (d**0.5))
    if causal:
        keep = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return weights @ v


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Dispatching multi-head attention on ``[B, H, S, D]``."""
    if q.is_cuda and q.shape[-1] <= MAX_HEAD_DIM and q.shape[-2] > _MIN_KERNEL_SEQ:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    return mha_plain(q, k, v, causal=causal)

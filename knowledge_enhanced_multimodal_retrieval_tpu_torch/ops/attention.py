"""Multi-head attention: the plain version and the dispatching ``mha``.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/ops/attention.py``:

- :func:`mha_plain` follows ``mha_xla`` (the dot in the input dtype, f32
  logits scaled after it, f32-min causal mask, f32 softmax, p cast to the
  input dtype before p@v);
- :func:`mha` launches the hand-written kernel
  (:func:`..ops.flash_attention.flash_attention`, the port of B6 and B7) for
  a CUDA tensor of any sequence length whose ``head_dim`` the kernel has
  (``<= 256``); a CPU tensor, and a wider head, run :func:`mha_plain`. The
  reference routes sequences of 128 and fewer tokens to its plain version;
  the port does not, by this measurement on an NVIDIA H100 80GB HBM3 at a
  700.00 W limit (``chip_smoke.py`` ``attention_routing_phase``, bf16, causal,
  device-only medians, kernel / ``mha_plain``): ``[256, 12, 77, 64]`` (the
  ``flax`` text tower) 0.051 / 0.681 ms, s = 16 0.019 / 0.090, s = 32
  0.025 / 0.121, s = 64 0.039 / 0.296, s = 128 0.073 / 0.990, one sequence
  of 77 tokens 0.007 / 0.037.
"""

from __future__ import annotations

import torch

from .flash_attention import MAX_HEAD_DIM, flash_attention


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
    if q.is_cuda and q.shape[-1] <= MAX_HEAD_DIM:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    return mha_plain(q, k, v, causal=causal)

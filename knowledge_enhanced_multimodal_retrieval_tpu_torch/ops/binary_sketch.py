"""Binary sign-sketch corpus: 1 bit per dimension, Hamming-distance scan.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/ops/binary_sketch.py``
(no Pallas kernel there: XOR + popcount in XLA; plain PyTorch here). Each
row reduces to its coordinate sign bits, 32 per word; the scan scores a
query's sketch against each tower with Hamming distances, maps them to the
proxy ``1 - 2 * hamming / dim`` and blends the towers with alpha. The proxy
is candidate-generation quality only: the retriever always reranks.
:func:`sharded_hamming_topk` scans a row-sharded sketch corpus shard by
shard and merges the winners.

The JAX package stores the words as uint32. PyTorch's uint32 arithmetic is
thin and it has no popcount, so the port keeps the same bits in int32 words
and counts them with a SWAR sequence whose masks clear every sign-extended
bit, which gives the unsigned counts exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .similarity import _merge_shard_winners, _segmented_topk_from_scores, alpha_column, sharded_scan

# corpus rows scored per step: bounds the [Q, chunk, words] XOR intermediate
_DEFAULT_CHUNK = 4096


def pack_sign_bits(emb: torch.Tensor) -> torch.Tensor:
    """``[N, D] -> int32 [N, ceil(D/32)]`` sign words: bit i of word w is
    ``emb[:, 32*w + i] > 0``; tail bits are zero, zero rows pack to zero."""
    n, d = emb.shape
    bits = (emb > 0).to(torch.int64)
    pad = (-d) % 32
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    weights = torch.ones(32, dtype=torch.int64, device=emb.device) << torch.arange(32, device=emb.device)
    words = (bits.reshape(n, -1, 32) * weights).sum(dim=-1)  # < 2**32, exact in int64
    return _as_int32_words(words)


def _as_int32_words(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same 32 bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_sign_bits_host(emb) -> np.ndarray:
    """Host (NumPy) packing, bit-identical to the JAX package's
    ``pack_sign_bits_host``: uint32 ``[N, ceil(D/32)]``. Upload with
    ``torch.from_numpy(words.view(np.int32))``."""
    emb = np.asarray(emb)
    n, d = emb.shape
    pad = (-d) % 32
    bits = emb > 0
    if pad:
        bits = np.pad(bits, ((0, 0), (0, pad)))
    words = bits.reshape(n, -1, 32).astype(np.uint32)
    return (words << np.arange(32, dtype=np.uint32)).sum(axis=-1, dtype=np.uint32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (as its unsigned 32 bits), int32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_scores(q_bits: torch.Tensor, c_bits: torch.Tensor, chunk: int = _DEFAULT_CHUNK) -> torch.Tensor:
    """``[Q, W] x [N, W] -> int32 [Q, N]`` Hamming distances, corpus-chunked
    so the XOR intermediate stays bounded."""
    out = []
    for lo in range(0, c_bits.shape[0], chunk):
        x = torch.bitwise_xor(q_bits[:, None, :], c_bits[None, lo : lo + chunk, :])
        out.append(popcount32(x).sum(dim=-1, dtype=torch.int32))
    return torch.cat(out, dim=1)


def hamming_topk(queries: torch.Tensor, cimg_bits: torch.Tensor, ctxt_bits: torch.Tensor, *, dim: int, k: int,
                 alpha=0.5, chunk: int = _DEFAULT_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blended sketch top-k: ``(proxy scores [Q, k], rows [Q, k])`` with the
    proxy ``alpha * (1 - 2 ham_img / dim) + (1 - alpha) * (1 - 2 ham_txt /
    dim)`` in f32, the JAX package's arithmetic. Rerank before serving."""
    q_bits = pack_sign_bits(queries)
    a = alpha_column(alpha, queries.shape[0], queries.device)
    inv = torch.tensor(2.0 / float(dim), dtype=torch.float32, device=queries.device)
    p_img = 1.0 - inv * hamming_scores(q_bits, cimg_bits, chunk).float()
    p_txt = 1.0 - inv * hamming_scores(q_bits, ctxt_bits, chunk).float()
    scores = a * p_img + (1.0 - a) * p_txt
    return _segmented_topk_from_scores(scores, min(k, cimg_bits.shape[0]), segment=4096)


def sharded_hamming_topk(queries: torch.Tensor, cimg_bits, ctxt_bits, *, dim: int, k: int, alpha, mesh,
                         axis: str = "data", chunk: int = _DEFAULT_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`hamming_topk` over a row-sharded sketch corpus: each device
    scans its local words, and only the per-shard ``[Q, k]`` winners move
    for the merge."""
    n = cimg_bits.shape[0]
    k = min(k, n)
    a = alpha_column(alpha, queries.shape[0], queries.device)

    def scan(dev, g, shard_n, ci, ct):
        return hamming_topk(queries.to(dev), ci, ct, dim=dim, k=min(k, shard_n), alpha=a.to(dev), chunk=chunk)

    all_v, all_i, _, _ = sharded_scan(mesh, axis, (cimg_bits, ctxt_bits), scan)
    return _merge_shard_winners(all_v, all_i, k)

"""GradCache: contrastive batches larger than activation memory allows.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/train/gradcache.py``
(Gao et al. 2021, arXiv:2101.06983), in three passes:

1. **embeddings**: each tower encodes the batch in ``n_chunks`` chunks under
   ``torch.no_grad()`` (one chunk's activations live at a time) into its
   full ``[B, D]`` table;
2. **loss**: the loss and its gradient with respect to the tables only;
3. **re-forward**: each chunk is encoded again with autograd on and
   ``backward(g_chunk)`` accumulates the parameters' gradients.

The result equals autograd over the whole batch up to summation order (the
loss depends on the tables alone), at about twice the encoder forward and
1/``n_chunks`` of the activation memory. Unlike ``grad_accum_steps`` the
negative pool stays the whole batch. Per-step state an encoder reads (the
FLIP ``keep_idx``, QAT's and LoRA's projection hooks) must be the same in
both passes: inputs are chunked with the images, hooks are held by the
caller over the whole call.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import torch

__all__ = ["gradcache_value_and_grad"]


def _split(x: torch.Tensor, n_chunks: int) -> tuple:
    b = x.shape[0]
    if b % n_chunks:
        raise ValueError(f"grad-cache chunk count {n_chunks} must divide the local batch {b} (got shape {tuple(x.shape)})")
    return x.chunk(n_chunks)


def _chunk(inputs: Sequence[Any], n_chunks: int) -> list:
    """[B, ...] inputs -> n_chunks tuples of [B / n_chunks, ...] slices; an
    input that is a list of data shards' tensors is chunked shard by shard
    (each chunk a list over the shards)."""
    cols = []
    for x in inputs:
        if isinstance(x, (list, tuple)):
            cols.append([list(c) for c in zip(*(_split(t, n_chunks) for t in x))])
        else:
            cols.append(_split(x, n_chunks))
    return list(zip(*cols))


def gradcache_value_and_grad(
    emb_loss: Callable[..., Tuple[torch.Tensor, Any]],
    towers: Sequence[Tuple[Callable, Sequence[torch.Tensor]]],
    params: Dict[str, torch.Tensor],
    n_chunks: int,
):
    """Value and gradient of ``emb_loss(*tables)`` with respect to ``params``.

    ``towers`` holds one ``(encode, inputs)`` pair per table the loss takes:
    ``encode(*chunk_inputs)`` maps ``[chunk, ...]`` slices to ``[chunk, D]``
    rows (or, over a mesh's data shards, lists of each shard's slices to
    ``[S, chunk, D]``: each shard is chunked on its own) and reads ``params`` (tensors with ``requires_grad``); ``emb_loss``
    returns ``(loss, aux)``. Returns ``((loss, aux), grads)`` with ``grads``
    by the names of ``params`` (zeros where a parameter got none), summed per
    tower over its chunks and then across towers, as the JAX version does;
    ``params``' ``.grad`` is left empty."""
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    chunked = [(enc, _chunk(ins, n_chunks)) for enc, ins in towers]
    with torch.no_grad():
        tables = [torch.cat([enc(*c) for c in chunks], dim=-2) for enc, chunks in chunked]
    leaves = [t.detach().requires_grad_(True) for t in tables]
    with torch.enable_grad():
        loss, aux = emb_loss(*leaves)
    g_tables = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads: Dict[str, torch.Tensor] = {}
    for (enc, chunks), t, g in zip(chunked, tables, g_tables):
        g = torch.zeros_like(t) if g is None else g
        for p in params.values():
            p.grad = None
        for c, g_c in zip(chunks, g.chunk(n_chunks, dim=-2)):
            enc(*c).backward(g_c)
        for n, p in params.items():  # a tower's sum over its chunks, then across towers
            if p.grad is not None:
                grads[n] = p.grad if n not in grads else grads[n] + p.grad
            p.grad = None
    grads = {n: grads[n] if n in grads else torch.zeros_like(p) for n, p in params.items()}
    return (loss.detach(), aux), grads

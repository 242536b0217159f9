"""PyTorch + CUDA port of knowledge_enhanced_multimodal_retrieval_tpu.

The JAX package beside this one is the reference each slice is held
against. This package imports ``torch`` and never ``jax``; it mirrors the
reference's sub-package and module names:

- ``ops``        — hand-written Hopper kernels (``csrc/``) behind wrappers
  that launch them on CUDA tensors and run plain versions on CPU tensors;
- ``models``     — the CLIP towers, weight conversion, serving plans;
- ``data``       — the BPE tokenizer, image preprocessing, datasets, batching;
- ``eval``       — encoding a dataset into normalized embeddings;
- ``retrieval``  — embedding store (and its precompute), CLIP retriever,
  RetrievalEngine;
- ``cli``        — the precompute and serving entry points.
"""

__version__ = "0.1.0"

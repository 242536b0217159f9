"""PyTorch + CUDA port of knowledge_enhanced_multimodal_retrieval_tpu.

The JAX package beside this one is the reference each slice is held
against. This package imports ``torch`` and never ``jax``; it mirrors the
reference's sub-package and module names:

- ``ops``        — hand-written Hopper kernels (``csrc/``) behind wrappers
  that launch them on CUDA tensors and run plain versions on CPU tensors;
- ``models``     — the CLIP text tower, weight conversion, serving plans;
- ``data``       — the BPE tokenizer;
- ``retrieval``  — embedding store, CLIP retriever, RetrievalEngine;
- ``cli``        — the serving entry point.
"""

__version__ = "0.1.0"

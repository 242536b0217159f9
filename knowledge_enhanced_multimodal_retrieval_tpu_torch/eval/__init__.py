"""Corpus encoding (the precompute half of the JAX package's eval)."""

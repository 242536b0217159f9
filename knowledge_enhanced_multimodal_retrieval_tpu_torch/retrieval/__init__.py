"""Embedding store, CLIP retriever and the RetrievalEngine serving API."""

"""Host-side data handling: the BPE tokenizer, image preprocessing, datasets and batching."""

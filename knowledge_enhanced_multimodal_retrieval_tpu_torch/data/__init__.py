"""Host-side data handling: the BPE tokenizer."""

"""Training support: the canonicalizer tokenizer."""

"""Training the canonicalizer: tokenizer, NL->signature data, AdamW with
optional int8 gradient compression, checkpoints in the JAX package's
on-disk format, and the restartable training loop."""

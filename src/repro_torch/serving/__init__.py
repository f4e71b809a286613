"""Serving: the batched generation engine, KV cache state and JSON-constrained decoding."""

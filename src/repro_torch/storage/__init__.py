"""Cache storage policies (admission and eviction scoring)."""

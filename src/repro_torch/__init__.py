"""PyTorch/CUDA port of the semantic cache for OLAP.

The JAX package ``repro`` is the reference; this package does the same work
on PyTorch, with every TPU kernel of its path rewritten by hand for NVIDIA
Hopper.  It imports neither JAX nor ``repro``: the pure-Python layers it
needs are copied here with their module paths kept, so the counterpart of
``repro/olap/executor.py`` is ``repro_torch/olap/executor.py``.  Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""

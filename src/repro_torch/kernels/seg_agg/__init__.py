"""Grouped aggregation: CUDA kernels (``kernel``), plain versions (``ref``)
and device dispatch (``ops``)."""

"""Chunked Mamba2 SSD scan: plain PyTorch versions, CUDA kernel, dispatch."""

"""Causal GQA prefill attention: plain PyTorch version, CUDA kernel, dispatch."""

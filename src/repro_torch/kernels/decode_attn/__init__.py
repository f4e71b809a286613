"""One-token GQA attention over a KV cache: plain PyTorch version, CUDA kernel, dispatch."""

"""Tensor ops: blocks, DCT, quantization, motion search and compensation,
and the CUDA kernels with their plain PyTorch versions."""

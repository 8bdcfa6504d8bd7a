"""Operators of the port: plain PyTorch functions on ``torch.Tensor``
and the wrappers of its hand-written CUDA kernels."""

"""Attention and loss ops; the attention kernels are CUDA C++ (csrc/)."""

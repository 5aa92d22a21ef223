"""Learned policies of the PyTorch port: the policy net and its fused kernels."""

"""Attention kernels (csrc/*.cu) with their plain PyTorch versions."""

"""PyTorch/CUDA port of motionclone_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX reference: it imports torch and numpy,
never jax, flax or motionclone_tpu.  Its entry points run on CUDA by default
and take ``device="cpu"`` for the CPU, where every kernel wrapper uses its
plain PyTorch version.
"""

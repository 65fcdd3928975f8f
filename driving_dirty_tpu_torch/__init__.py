"""PyTorch and CUDA port of driving_dirty_tpu for one NVIDIA H100.

The layout mirrors the JAX package (checkpoints/, core/, ops/, nn/, models/,
metrics/, data/, cli/) so each module's counterpart is easy to find. Kernels
written by hand for Hopper live in csrc/ (CUDA C++) with their Python
wrappers and plain PyTorch versions in kernels/.
"""

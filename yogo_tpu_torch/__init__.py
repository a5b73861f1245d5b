"""PyTorch/CUDA port of yogo_tpu for NVIDIA Hopper GPUs.

Module names follow yogo_tpu's, so each module's counterpart is easy to
find. The package imports torch and never jax, flax or yogo_tpu. Entry
points run on CUDA unless the caller passes device="cpu".
"""

"""PyTorch / CUDA port of video_chapter_generation_tpu for NVIDIA Hopper.

The layout mirrors the JAX package (`ops/`, `models/`, `pipeline/`), so each
module's counterpart sits under the same path. Hand-written CUDA kernels
for the vision trunk live in `csrc/` and build at first CUDA use
(`ops/_build.py`); on CPU tensors every kernel wrapper runs its plain
PyTorch version. Importing this package imports no jax or flax.
"""

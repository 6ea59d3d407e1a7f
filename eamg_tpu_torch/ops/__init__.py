"""The hand-written Hopper kernels and their plain PyTorch versions.

Each module holds kernel wrappers and their plain versions. A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches
the kernel or raises, and counts the launch under its own name in
``_build.launch_counts()``.
"""

"""The hand-written Hopper kernels and their plain PyTorch versions.

Each module holds one kernel's wrapper, its plain version and an integer
``launches`` counter. A wrapper given CPU tensors runs the plain version;
given CUDA tensors it launches the kernel or raises.
"""

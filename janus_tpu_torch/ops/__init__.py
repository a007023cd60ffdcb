"""Tensor ops of the send and receive paths and the wrappers of the hand-written CUDA
kernels. Importing this package builds nothing and imports no compiler:
kernels are built at their first launch (see :mod:`.cuda_build`)."""

"""On-device ops: the normalize kernel and the augmentation around it, and
flash attention (CUDA C++ kernels built by ``_cuda_build``)."""

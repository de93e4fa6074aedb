"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions.

A wrapper takes its plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises. Each kernel module keeps a
`LAUNCHES` dict that its wrappers add one to where they launch a kernel.
"""

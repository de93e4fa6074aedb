"""localrf_tpu_torch — the PyTorch/CUDA port of localrf_tpu.

Mirrors the JAX package's layout and function names with PyTorch idiom
inside: the field is an `nn.Module` whose parameter names are the JAX dict
keys, ops are plain functions on tensors, randomness comes from explicit
`torch.Generator`s, and every Pallas kernel on the training step is a CUDA
kernel written by hand for Hopper (`csrc/`), wrapped in a
`torch.autograd.Function` where it needs a gradient.

Kernel wrappers take their plain PyTorch version only for tensors on the
CPU; a CUDA tensor launches the kernel or raises. The package imports
`torch` and never `jax`, and nothing of the JAX package: what it needs of
a numpy-only module there (the datasets, the flow decoder) it keeps as its
own copy under `data/`. Its entry points (`LocalTensorfs`,
`DevicePixelPool`, the `convert.py` functions) run on the card unless the
caller passes `device="cpu"`.
"""

__version__ = "0.1.0"

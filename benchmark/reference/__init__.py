"""Plain f32 PyTorch reference of a LocalRF training step and eval frame.

Written from the published method (TensoRF-VM fields, LocalRF's losses and
schedule, Adam) with plain PyTorch operations only: F.grid_sample lookups
in the canonical factor grids, torch.cumprod compositing, autograd, and no
kernel, quad table, captured graph or code of the measured program. Every
matmul runs in full f32 (`full_f32`). `precision="fp8"` rounds the factor
grids, the shading MLP's weights and its layer inputs to float8 e4m3 and
the gradients flowing back into them to float8 e5m2 (per-tensor scales):
the benchmark's control, fp8 where the configuration states bf16.
"""

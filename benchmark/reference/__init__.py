"""Plain f32 PyTorch reference of a LocalRF training step and eval frame.

Written from the published method (TensoRF fields, LocalRF's losses and
schedule, Adam) with plain PyTorch operations only: F.grid_sample lookups
in the canonical factor grids, torch.cumprod compositing, autograd, and no
kernel, quad table, captured graph or code of the measured program. Every
matmul runs in full f32 (`full_f32`). `precision="fp8"` rounds the factor
grids, the shading MLP's weights and its layer inputs to float8 e4m3 and
the gradients flowing back into them to float8 e5m2 (per-tensor scales):
the benchmark's control, fp8 where the configuration states bf16.

The field module. What differs between field decompositions lives in one
module of this package, `<stem>.py`, which a configuration names by its
"field" key (none: `field.py`, TensoRF-VM). The harness loads it as
`reference.<stem>`, so it may import the shared parts relatively (`from
.field import density, line_lookup, rounder`). `wd` is
harness/scene.py's `widths(config)`: "density" and "app" (the published
n_lamb_sigma and n_lamb_sh lists), "app_dim", "feature_c", the head's
keys, "act". It defines:

- `weight_shapes(wd, grid) -> (factors, dense)`: two {name: shape} dicts in
  the published layout, with the program's parameter names. Factor tables
  are drawn 0.1 N(0, 1), dense weights ([fan_in, fan_out]) uniform in
  +-1/sqrt(fan_in); the shading head's weights are added by the harness.
- `features(params, pts, q) -> (sigma_feat [P], app [P, app_dim])` at
  normalized points [P, 3] in [-1, 1], each tensor read through `q`
  (field.rounder: the control's rounding).
- `density_l1_grads(params, act) -> (l1, {name: gradient})`: the density
  L1 term (before its weight) and its gradients w.r.t. the field's
  tensors, with the density activation `act` (field.density).
- `lookup_ops(wd) -> int`: the lookups' operations at one sample point,
  the field's part of harness/flops.py point_forward.
- `l1_voxel_ops(wd) -> int`: the L1 term's operations at one voxel of the
  grid.
- `plane_sum_bytes(wd, grid, rays, samples) -> int | None`: the bytes the
  step's plane sums (K2) must move, None for a field with no plane sums.

Shared by every field, in field.py: the density activation (`density`),
the shading heads (`shade`; their shapes: harness/scene.py mlp_shapes),
`rounder` and `full_f32`; in render.py and step.py: sampling, compositing,
the losses, the step and Adam.
"""

"""Ray-batch data parallelism over torch.distributed ranks (PyTorch port of
localrf_tpu/parallel/sharding.py).

The JAX package is single-controller: one process sees N devices, shards
the ray batch over a mesh and lets GSPMD insert the gradient psum in the
jitted step. Here each rank is one process on one card (launched by
`torch.distributed.run`), and the port keeps the math of that design:

- views stay on one rank: the batch is view-major, so a rank takes a
  contiguous slice of the views with their rays (`shard_batch`), and the
  per-view quantile rejection of the flow and depth losses needs no
  cross-rank sort;
- parameters, optimizer state and the pixel pool are replicated: every
  rank builds them from the same seed and data, and a broadcast from rank
  0 (`replicate_tree`) makes the trained state equal where events rebuild
  it;
- gradients are reduced once per step (`all_mean`, called from
  models/step.py::loss_grads), in f32, through one buffer;
- eval splits each chunk's rays over the ranks (models/local.py).

On NCCL the collectives are captured in a chunk's CUDA graphs; gloo runs a
collective on the host, which a graph cannot capture
(`captures_collectives`). On CUDA tensors gloo offers only `broadcast` and
`all_reduce`, so every collective here is one of those two.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"

# batch keys whose leading axis is the ray/view axis (shardable); a copy of
# the JAX package's list
_SHARDED_KEYS = (
    "ray_idx",
    "view_ids",
    "rgbs",
    "loss_weights",
    "fwd_flow",
    "bwd_flow",
    "fwd_mask",
    "bwd_mask",
    "invdepths",
)
# index-stream keys of the pooled path whose axis is the ray/view axis
POOL_SHARDED_KEYS = ("px", "slots", "view_ids")

# collectives issued by all_sum_ and replicate_tree since the last reset: a
# captured chunk issues its steps' collectives at warm-up and capture only,
# its replays call no Python
COLLECTIVES = {"all_reduce": 0, "broadcast": 0}


def make_mesh(n: int | None = None, device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh ("data",) over the first n ranks of the default process
    group (every rank by default), which must be initialized; on CUDA the
    caller sets each rank's card first."""
    n = dist.get_world_size() if n is None else n
    return init_device_mesh(device_type, (n,), mesh_dim_names=(DATA_AXIS,))


def data_rank(mesh: DeviceMesh) -> tuple[int, int]:
    """(this rank's index along "data", the size of "data")."""
    return mesh.get_local_rank(DATA_AXIS), mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))


def captures_collectives(mesh: DeviceMesh) -> bool:
    """Whether a CUDA graph can capture the mesh's collectives: NCCL's run
    on the card; gloo's run on the host (CUDA tensors staged through host
    memory), which no graph records."""
    return dist.get_backend(mesh.get_group(DATA_AXIS)) == "nccl"


def shard_batch(batch: dict, mesh: DeviceMesh, keys=_SHARDED_KEYS, axis: int = 0) -> dict:
    """This rank's part of a batch of numpy arrays or tensors: of each key in
    `keys`, the contiguous slice of the ray/view axis `axis` that belongs to
    the rank; every other key whole. When any of those keys does not divide
    by the size of "data" (n_views % world != 0), every rank takes the whole
    batch, as JAX replicates an indivisible array (JAX decides key by key; a
    rank here needs its views and their rays together, so the rule holds for
    the batch as a whole)."""
    rank, n = data_rank(mesh)
    split = [k for k, v in batch.items() if k in keys and v is not None]
    if n == 1 or any(batch[k].shape[axis] % n for k in split):
        return dict(batch)
    out = dict(batch)
    for k in split:
        m = batch[k].shape[axis] // n
        out[k] = batch[k][(slice(None),) * axis + (slice(rank * m, (rank + 1) * m),)]
    return out


def _leaves(tree) -> list[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    raise TypeError(f"replicate_tree: cannot replicate a {type(tree).__name__}")


@torch.no_grad()
def replicate_tree(tree, mesh: DeviceMesh):
    """Make every tensor of `tree` (tensors, modules' parameters, dicts,
    lists and tuples of them) equal to rank 0's, in place, bit for bit: one
    broadcast of their bytes over "data". Returns `tree`."""
    leaves = _leaves(tree)
    if not leaves:
        return tree
    for t in leaves:
        if not t.is_contiguous():
            raise ValueError("replicate_tree broadcasts contiguous tensors in place")
    raw = [t.detach().reshape(-1).view(torch.uint8) for t in leaves]
    flat = torch.cat(raw)
    group = mesh.get_group(DATA_AXIS)
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    COLLECTIVES["broadcast"] += 1
    torch._foreach_copy_(raw, list(flat.split([r.numel() for r in raw])))
    return tree


def all_sum_(t: torch.Tensor, mesh: DeviceMesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """In place: the sum of `t` over the mesh axis `axis`, one
    all_reduce(SUM), the same bits on every rank. A gather is this sum over
    a zero-filled buffer in which each rank wrote its own part (gloo has no
    other collective for CUDA tensors). Returns `t`."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    COLLECTIVES["all_reduce"] += 1
    return t


def all_mean(tensors: list[torch.Tensor], mesh: DeviceMesh) -> list[torch.Tensor]:
    """The mean over "data" of each tensor, as a new tensor of its dtype and
    shape: the tensors are flattened into one f32 buffer (the dtype of the
    master parameters; never a bf16 sum), reduced by one all_reduce(SUM)
    and divided by the size of "data". Every rank gets the same bits. This
    is the one reduction of the training step's gradients and metrics and
    of the rgb loss's denominator; it neither syncs the host nor copies
    host data, so a CUDA graph captures it (on NCCL)."""
    _, n = data_rank(mesh)
    flat = all_sum_(torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors]), mesh)
    flat = flat.div_(n)
    return [part.reshape(t.shape).to(t.dtype) for part, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

"""The chunk executor on CUDA: captured CUDA graphs of one training step.

The PyTorch counterpart of one jitted `lax.scan` of JAX's `train_chunk` /
`train_chunk_pooled`: one whole training step (the pooled batch gather,
forward, `torch.autograd.grad`, gated Adam) is captured with
`torch.cuda.graph` once per key (StepStatics, StepBranches) and replayed for
every step of a chunk, so the host launches one graph per step instead of
about a thousand kernels.

A graph bakes in the addresses it reads and writes:
- each step's inputs (index-stream or batch row, scalars, noise) live in
  static buffers here; before every step one multi-tensor copy brings row k
  of the chunk's [K, ...] device streams into them;
- the pose window and the intrinsics, with their Adam state, are static
  buffers here too: copied in from the caller at the start of a chunk
  (unless they already are these buffers), updated by the graph, and handed
  back at the end;
- the field's parameters and Adam state (updated in place by the step), the
  alpha volume and the pixel pool (read only) are bound by address: when
  any of them differs from what the graphs were captured with (a schedule
  event made new tensors), every graph is dropped and captured again. The
  caller also drops them at every schedule event (`drop`), so that at most
  one set of graphs holds memory.

Capture: the first step of a key runs eagerly on a side stream (the
warm-up: it computes that step, which builds the kernels at first use, with
torch's sync check set to "error" so that a host sync names its op instead
of breaking the capture); then the same step is captured (capture records,
it does not run). Every later step of that key is a replay. All graphs share
one memory pool: they never run at once. Nothing falls back to eager steps:
a failed capture or replay raises.

The kernel wrappers' launch counters (LAUNCHES) count at capture, not at
replay, and a host span inside the step runs only at capture too. What a
replay does is seen on the card: every step graph holds the tracer's
device stamps (utils/profiling.py) at its module boundaries, which write
one row of this executor's stamp ring (`ring`) at each replay, the row
taken from the step's static inputs; a profiler trace of a replayed chunk
shows which kernels ran. `captures` and `replays` count here, and
`run_chunk` hands them to the tracer's counters while it records.
"""
from __future__ import annotations

import contextlib

import torch

from ..utils import profiling
from .step import FieldState, IntrState, PoseState, StepBranches, StepStatics, metric_names, train_core
from ..optim import AdamState, PyTreeAdamState


def _pose_leaves(p: PoseState) -> list[torch.Tensor]:
    return [p.r, p.t, p.exposure, *p.r_opt, *p.t_opt, *p.e_opt]


def _pose_from(leaves: list[torch.Tensor]) -> PoseState:
    return PoseState(*leaves[:3], AdamState(*leaves[3:7]), AdamState(*leaves[7:11]),
                     AdamState(*leaves[11:15]))


def _intr_leaves(i: IntrState) -> list[torch.Tensor]:
    o = i.opt
    return [*i.params.values(), *o.m.values(), *o.v.values(), o.step, o.lr_scale]


def _intr_from(leaves: list[torch.Tensor], like: IntrState) -> IntrState:
    names = list(like.params)
    n = len(names)
    return IntrState(
        dict(zip(names, leaves[:n])),
        PyTreeAdamState(dict(zip(names, leaves[n:2 * n])), dict(zip(names, leaves[2 * n:3 * n])),
                        leaves[3 * n], leaves[3 * n + 1]),
    )


def _addr(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.dtype, tuple(t.stride()))


def _layout(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), t.dtype)


def _copy_into(dst: list[torch.Tensor], src: list[torch.Tensor]) -> None:
    pairs = [(d, s) for d, s in zip(dst, src) if d is not s]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


@contextlib.contextmanager
def _sync_check():
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class _Buffers:
    """The static buffers one set of graphs reads and writes."""

    def __init__(self, pose: PoseState, intr: IntrState, seqs: dict[str, dict], n_metrics: int, ring_rows: int):
        self.pose = _pose_from([torch.empty_like(t) for t in _pose_leaves(pose)])
        self.intr = _intr_from([torch.empty_like(t) for t in _intr_leaves(intr)], intr)
        # step inputs: {"inputs": ..., "scalars": ..., "noise": ...}, each {key: one step's tensor}
        self.step = {
            part: {k: torch.empty(v.shape[1:], dtype=v.dtype, device=v.device) for k, v in seq.items()}
            for part, seq in seqs.items()
        }
        self.metrics = torch.empty((n_metrics,), device=pose.r.device)
        # every step's device stamps, row step["stamp"]["row"]
        self.stamps = profiling.train_ring(ring_rows, pose.r.device, self.step["stamp"]["row"])

    def step_leaves(self) -> list[torch.Tensor]:
        return [t for part in self.step.values() for t in part.values()]


class ChunkGraphs:
    """Captured graphs of one training step on one card, replayed per step."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"ChunkGraphs captures CUDA graphs, got device {self.device}")
        self.graphs: dict[tuple[StepStatics, StepBranches], torch.cuda.CUDAGraph] = {}
        self.captures = 0  # graphs captured since construction
        self.replays = 0  # graph replays since construction
        self._binding = None
        self._buf: _Buffers | None = None
        self._pool = None
        # the warm-up stream, one for the life of the executor: cuBLAS caches
        # a workspace for each stream it ran on
        self._side = torch.cuda.Stream(self.device)

    def __len__(self) -> int:
        return len(self.graphs)

    @property
    def ring(self) -> profiling.StampRing | None:
        """The stamp ring the graphs write (row k at a chunk's step k)."""
        return None if self._buf is None else self._buf.stamps

    def drop(self) -> None:
        """Release every graph (and its memory) and the static buffers."""
        self.graphs.clear()
        self._binding = None
        self._buf = None
        self._pool = None

    def run(self, field: FieldState, pose: PoseState, intr: IntrState, statics: StepStatics,
            alpha_volume, batch_of, bound, inputs_seq: dict, scalars_seq: dict, noise_seq: dict,
            branches_seq: list[StepBranches], n_steps: int, mesh=None):
        """K steps: step k's inputs are row k of the [K, ...] streams;
        batch_of(inputs) builds the step's batch inside the graph. Returns
        (field, pose, intr, metrics {name: [K]}) like step.train_chunk.
        With a `mesh` (NCCL) the step's collectives are captured with it;
        the mesh must already have made one collective eagerly (NCCL makes
        its communicator at the first, which a capture cannot do):
        LocalTensorfs.set_mesh does, with its broadcast of the state."""
        ring_rows = max(profiling.RING_ROWS, n_steps + 1)
        seqs = {"inputs": inputs_seq, "scalars": scalars_seq, "noise": noise_seq,
                "stamp": {"row": torch.arange(n_steps, device=self.device)}}
        names = metric_names(statics)
        binding = (
            tuple(_addr(t) for t in field.params.parameters()),
            tuple(_addr(t) for t in (*field.opt.m.values(), *field.opt.v.values(),
                                     field.opt.step, field.opt.lr_scale)),
            None if alpha_volume is None else _addr(alpha_volume),
            tuple(_addr(t) for t in bound),
            tuple(_layout(t) for t in _pose_leaves(pose) + _intr_leaves(intr)),
            tuple((part, k, tuple(v.shape[1:]), v.dtype) for part, seq in seqs.items()
                  for k, v in seq.items()),
            id(mesh),
            ring_rows,
        )
        if binding != self._binding:
            self.drop()
            self._buf = _Buffers(pose, intr, seqs, len(names), ring_rows)
            self._binding = binding
        buf = self._buf
        _copy_into(_pose_leaves(buf.pose), _pose_leaves(pose))
        _copy_into(_intr_leaves(buf.intr), _intr_leaves(intr))

        def step(branches: StepBranches):
            b = buf.step
            with profiling.stamping(buf.stamps):
                profiling.stamp("start")
                _, new_pose, _, metrics = train_core(
                    field, buf.pose, buf.intr, batch_of(b["inputs"]), b["scalars"], statics, b["noise"],
                    alpha_volume, branches, mesh,
                )
                _copy_into(_pose_leaves(buf.pose), _pose_leaves(new_pose))
                buf.metrics.copy_(torch.stack([metrics[n] for n in names]))
                profiling.stamp("end")

        out = torch.empty((n_steps, len(names)), device=self.device)
        streams = [v for seq in seqs.values() for v in seq.values()]
        for k in range(n_steps):
            torch._foreach_copy_(buf.step_leaves(), [v[k] for v in streams])
            key = (statics, branches_seq[k])
            graph = self.graphs.get(key)
            if graph is None:
                self.graphs[key] = self._warm_up_and_capture(lambda: step(key[1]))
            else:
                graph.replay()
                self.replays += 1
            out[k].copy_(buf.metrics)
        return field, buf.pose, buf.intr, {n: out[:, i] for i, n in enumerate(names)}

    def _warm_up_and_capture(self, step) -> torch.cuda.CUDAGraph:
        """Run `step` eagerly on a side stream (this step's update), then
        capture it; raises if either fails."""
        current = torch.cuda.current_stream(self.device)
        side = self._side
        side.wait_stream(current)
        with torch.cuda.stream(side), _sync_check():
            step()
        current.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with profiling.span("graph.capture"), torch.cuda.graph(graph, pool=self._pool):
            step()
        self.captures += 1
        return graph

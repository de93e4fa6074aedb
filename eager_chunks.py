"""The eager reference on a card for the port's captured chunks.

On a card `LocalTensorfs.run_chunk` replays captured graphs of one step
(models/graph.py's ChunkGraphs) and has no eager path without a gloo mesh.
`eager_steps(model)` puts an EagerSteps in the place of the model's graphs
for a block: run_chunk keeps its host schedule, staging and events, and its
steps run one `train_core` after another (step.run_steps, the CPU's chunk).
chip_smoke.py and the card tests hold replayed graphs against it; a CPU
test (tests/test_torch_chunk.py) holds it against the CPU's own chunk, so
that it follows ChunkGraphs.run's signature.
"""
from __future__ import annotations

import contextlib


class EagerSteps:
    """ChunkGraphs' interface, each step taken eagerly (step.run_steps),
    stamping into a ring of its own while the tracer records."""

    captures = replays = 0
    ring = None

    def drop(self) -> None:
        pass

    def run(self, field, pose, intr, statics, alpha_volume, batch_of, bound, inputs_seq, scalars_seq,
            noise_seq, branches_seq, n_steps, mesh=None):
        from localrf_tpu_torch.models.step import run_steps
        from localrf_tpu_torch.utils import profiling

        self.ring = profiling.train_ring(n_steps, pose.r.device) if profiling.recording() else None
        return run_steps(field, pose, intr, batch_of, inputs_seq, scalars_seq, statics, noise_seq, n_steps,
                         alpha_volume, branches_seq, mesh, self.ring)


@contextlib.contextmanager
def eager_steps(model):
    """Within the block `model`'s run_chunk takes its steps eagerly
    (EagerSteps); its captured graphs are kept for after."""
    graphs, model._graphs = model._graphs, EagerSteps()
    try:
        yield model
    finally:
        model._graphs = graphs

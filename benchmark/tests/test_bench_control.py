"""What `correct` is made of, on the CPU at the tiny cells' size: the
sound program passes its limits; the control (the reference in float8
e4m3 where the configuration states bf16) fails one of them; and a run
whose timed path is broken underneath comes out not correct, for each
fault the cells can have: a step that returns its state unchanged, half
of the batch left out (the mean taken over the rest), an answer altered
where it is produced."""
from __future__ import annotations

import dataclasses

import pytest
import torch
from conftest import TINY_LIMITS, run_tiny

from harness import check, manifest
from run import Run


@pytest.mark.parametrize("cell", ["tiny.tiny-train", "tiny.tiny-eval"])
def test_the_sound_program_is_correct(tiny, cell):
    res = run_tiny(tiny, cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("seed", [3_000_000_001, 3_000_007_920])
def test_the_fp8_control_is_not_correct(tiny, seed):
    spec = manifest.cell_spec("tiny.tiny-train", tiny)
    entry = manifest.entry_module("train", tiny)
    state = entry.setup(spec, Run(torch.device("cpu"), seed, 0.0, False))
    args = (spec, state["sd"], state["frames"], state["weights"], torch.device("cpu"))
    ref = entry.reference_side(*args)
    ok, _ = check.judge(check.train_numbers(entry.reference_side(*args, precision="fp8"), ref),
                        TINY_LIMITS["tiny-train"])
    assert not ok
    espec = manifest.cell_spec("tiny.tiny-eval", tiny)
    eentry = manifest.entry_module("eval", tiny)
    frames, weights, traj = eentry.program_frames(espec, Run(torch.device("cpu"), seed, 0.0, False), [1, 2])
    ref = eentry.reference_frames(espec, weights, traj, [1, 2], torch.device("cpu"))
    fp8 = eentry.reference_frames(espec, weights, traj, [1, 2], torch.device("cpu"), "fp8")
    assert check.judge(check.eval_numbers(frames, ref), TINY_LIMITS["tiny-eval"])[0]
    assert not check.judge(check.eval_numbers(fp8, ref), TINY_LIMITS["tiny-eval"])[0]


def _frozen(monkeypatch):
    """Every optimizer step returns its state unchanged."""
    from localrf_tpu_torch.models import step

    monkeypatch.setattr(step, "adam_update", lambda param, grad, state, gate=None: (param, state))
    monkeypatch.setattr(step, "pytree_adam_update", lambda params, grads, state, lrs, gate=None: (params, state))


def _half_batch(monkeypatch):
    """Each step's losses over the first half of its views, the mean over those."""
    from localrf_tpu_torch.models import step

    losses = step._losses

    def half(params, pose, intr, statics, batch, *args, **kw):
        v = statics.n_views // 2
        b = v * statics.px_per_view
        cut = {k: x[:v] if k == "view_ids" else x if k == "gate" else x[:b] for k, x in batch.items()}
        return losses(params, pose, intr, dataclasses.replace(statics, n_views=v), cut, *args, **kw)

    monkeypatch.setattr(step, "_losses", half)


def _eval_fault(monkeypatch, kind: str):
    """forward_eval's rgb with one pixel's value moved by 0.5 (altered) or
    the second half of the pixels left black (half left out)."""
    from localrf_tpu_torch.models.local import LocalTensorfs

    forward = LocalTensorfs.forward_eval

    def broken(self, *args, **kw):
        rgb, *rest = forward(self, *args, **kw)
        rgb = rgb.clone()
        if kind == "altered":
            rgb[0] = (rgb[0] + 0.5) % 1.0
        else:
            rgb[rgb.shape[0] // 2:] = 0.0
        return (rgb, *rest)

    monkeypatch.setattr(LocalTensorfs, "forward_eval", broken)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.tiny-train", "unchanged"), ("tiny.tiny-train", "half_batch"),
    ("tiny.tiny-eval", "altered"), ("tiny.tiny-eval", "half_batch"),
])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    if cell.endswith("train"):
        (_frozen if fault == "unchanged" else _half_batch)(monkeypatch)
    else:
        _eval_fault(monkeypatch, fault)
    res = run_tiny(tiny, cell)
    assert not res["correct"], res["checks"]


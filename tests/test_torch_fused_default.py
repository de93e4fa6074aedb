"""Which feature path render_rays takes. `TensorfConfig.fused_march` is on
by default in the port (JAX's default is off), so every field that fits the
fused march core (`fused_march_supported`: VM 8/24, app_dim 27, featureC
128, MLP_Fea_late_view, no PE, a cubic grid) takes it, counted as
`march.fused`; every other field, and `fused_march=False`, takes the
unfused path, counted as `march.unfused`. A checkpoint keeps the value it
was written with. On the CPU the fused core is its plain version
(`march_core_plain`). This file imports no jax.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from localrf_tpu_torch import checkpoint as tckpt
from localrf_tpu_torch.models import render as trender
from localrf_tpu_torch.models import tensorf as ttf
from localrf_tpu_torch.models.local import LocalConfig, LocalTensorfs
from localrf_tpu_torch.ops.kernels import march as k4
from localrf_tpu_torch.utils import profiling

GRID = (16, 16, 16)
N_RAYS, N_SAMPLES = 24, 48
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "jax_ckpt_12.th")
# fields the fused core does not fit, and the flag turned off at its widths
UNFUSED = {
    "vm192": dict(density_n_comp=(16, 16, 16), app_n_comp=(48, 48, 48), shading_mode="MLP_Fea", fea_pe=2,
                  view_pe=2),
    "cp": dict(decomposition="cp", density_n_comp=(8,), app_n_comp=(24,)),
    "non-cubic": dict(grid_size=(16, 16, 12)),
    "flag-off": dict(fused_march=False),
}


def _render(cfg: ttf.TensorfConfig) -> tuple[dict, dict]:
    """A training render of seeded rays through a seeded field while the
    tracer records: ({rgb, depth, every parameter's gradient}, counters)."""
    field = ttf.init_tensorf(cfg, torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(5)
    o = torch.from_numpy(rng.uniform(-0.5, 0.5, (N_RAYS, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(N_RAYS, 3)).astype(np.float32))
    noise = trender.draw_noise(N_SAMPLES, torch.Generator().manual_seed(7), "cpu")
    profiling.RECORDER.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        rgb, depth = trender.render_rays(field, cfg, o, d, is_train=True, white_bg=False, noise=noise,
                                         n_samples=N_SAMPLES)
        counters = profiling.counters()
    names = [n for n, _ in field.named_parameters()]
    loss = rgb.square().sum() + depth.sum()
    grads = torch.autograd.grad(loss, list(field.parameters()), allow_unused=True)
    out = {"rgb": rgb.detach(), "depth": depth.detach()}
    out.update({n: g for n, g in zip(names, grads) if g is not None})
    return out, counters


def _equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _spy_core(monkeypatch) -> list:
    calls = []
    core = k4.march_core

    def spy(*args):
        calls.append(args[0].shape[0])
        return core(*args)

    monkeypatch.setattr(k4, "march_core", spy)
    return calls


def test_default_field_takes_the_fused_march(monkeypatch):
    """A default TensorfConfig (the default widths and head, a cubic grid)
    runs the fused core once, counts `march.fused` and no `march.unfused`,
    and equals an explicit fused_march=True bit for bit."""
    cfg = ttf.TensorfConfig(grid_size=GRID)
    assert cfg.fused_march and k4.fused_march_supported(cfg)
    calls = _spy_core(monkeypatch)
    got, counters = _render(cfg)
    assert len(calls) == 1 and calls[0] % N_RAYS == 0  # one call over every sample of the rays
    assert counters.get("march.fused") == 1 and "march.unfused" not in counters
    want, _ = _render(dataclasses.replace(cfg, fused_march=True))
    _equal(got, want)


@pytest.mark.parametrize("case", list(UNFUSED))
def test_other_fields_take_the_unfused_path(case, monkeypatch):
    """vm192's widths and head, a CP field, a non-cubic grid and
    fused_march=False run no fused core, count `march.unfused` and no
    `march.fused`, and equal the unfused branch forced by hand (the support
    check patched to refuse) bit for bit."""
    cfg = ttf.TensorfConfig(**{"grid_size": GRID, **UNFUSED[case]})
    calls = _spy_core(monkeypatch)
    got, counters = _render(cfg)
    assert calls == []
    assert counters.get("march.unfused") == 1 and "march.fused" not in counters
    monkeypatch.setattr(trender, "fused_march_supported", lambda cfg: False)
    want, _ = _render(dataclasses.replace(cfg, fused_march=True))
    _equal(got, want)


def test_jax_checkpoint_loads_with_the_fused_march_off():
    """The committed JAX-written file (JAX's default fused_march False)
    loads with it off, in the model's config and in every field's."""
    m = tckpt.load_checkpoint(FIXTURE, device="cpu")
    assert not m.cfg.tensorf.fused_march
    assert len(m.fields) >= 2 and not any(f["cfg"].fused_march for f in m.fields)


@pytest.mark.parametrize("fused", [True, False])
def test_port_checkpoint_keeps_its_fused_march(fused, tmp_path):
    """A port file loads with the fused_march it was written with."""
    tf = ttf.TensorfConfig(grid_size=(12, 12, 12), fused_march=fused)
    m = LocalTensorfs(LocalConfig(WH=(20, 16), n_init_frames=3, tensorf=tf), device="cpu")
    path = str(tmp_path / "ckpt.th")
    tckpt.save_checkpoint(m, path)
    back = tckpt.load_checkpoint(path, device="cpu")
    assert back.cfg.tensorf.fused_march is fused
    assert all(f["cfg"].fused_march is fused for f in back.fields)

"""Configurations of other fields, added as files only, on the CPU at 32^3:
every key of a configuration reaches the program and the reference or
raises; TensoRF's LLFF field keys (`tests/fixtures/tensorf-llff.json`,
relu density) run relu on both sides: with f32 tables and MLP, where the
two compute the same function, they pass tensorf-vm192.refine-300's
limits; as stated (bf16), a reference that runs softplus instead fails
`loss_gap` (the relu reference there reads loss_gap 1.3e-4 to 8.6e-4 on
the depth loss: relu passes the program's bf16 gather arithmetic straight
into the density, so a relu cell's limits are its own). A configuration
that names another field module (`tests/fixtures/fixture-lines.json`,
`fixture_lines.py`) gets its shapes, features, L1 term and counts from
that module."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch
from conftest import BENCH, make_tiny, run_tiny

from harness import check, flops, manifest, program, scene
from reference.step import POSE_LEAVES
from run import Run

FIXTURES = Path(__file__).resolve().parent / "fixtures"
CPU = torch.device("cpu")
SEED = 2**31 + 4099


def test_every_key_is_mapped_or_raises():
    spec = manifest.cell_spec("tensorf-vm192.refine-300")
    cfg, traffic = spec["config"], spec["traffic"]
    with pytest.raises(ValueError, match="nLamb"):
        program.local_config({**cfg, "nLamb": [1]}, traffic, 100)
    relu = {**cfg, "fea2denseAct": "relu"}
    assert program.local_config(relu, traffic, 100).tensorf.fea2dense_act == "relu"
    assert scene.widths(relu)["act"] == "relu" and scene.widths(cfg)["act"] == "softplus"
    # "program": TensorfConfig fields of the port, verbatim; unknown names raise
    tf = program.local_config({**cfg, "program": {"fused_march": True, "line_bwd": "segsum"}}, traffic, 100).tensorf
    assert tf.fused_march and tf.line_bwd == "segsum"
    with pytest.raises(TypeError):
        program.local_config({**cfg, "program": {"no_such_field": 1}}, traffic, 100)
    # every key of the benchmark's configurations and fixtures is in the table
    for path in [*(BENCH / "configs").glob("*.json"), *FIXTURES.glob("*.json")]:
        assert set(json.loads(path.read_text())) <= set(program.KEYS) | program.DESCRIPTIVE, path


def _llff(root: Path, overrides: dict | None = None) -> Path:
    """The tiny copy cut from the LLFF fixture, with tensorf-vm192.refine-300's limits."""
    bench = make_tiny(root, overrides, config=FIXTURES / "tensorf-llff.json")
    limits = json.loads((BENCH / "workloads" / "tensorf-vm192.refine-300.json").read_text())["limits"]
    path = bench / "workloads" / "tiny.tiny-train.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "limits": limits}))
    return bench


def test_relu_configuration_is_correct_at_vm192_limits(tmp_path):
    bench = _llff(tmp_path, {"gather_dtype": "float32", "mlp_dtype": "float32"})
    res = run_tiny(bench, "tiny.tiny-train", seed=SEED)
    assert res["correct"], res["checks"]


def test_relu_program_against_a_softplus_reference_fails_loss_gap(tmp_path):
    bench = _llff(tmp_path)
    spec = manifest.cell_spec("tiny.tiny-train", bench)
    entry = manifest.entry_module("train", bench)
    state = entry.setup(spec, Run(CPU, SEED, 0.0, False))
    assert state["model"].cfg.tensorf.fea2dense_act == "relu"
    prog = entry.program_side(state["prog"], state["weights"], spec["traffic"]["frames"])
    args = (state["sd"], state["frames"], state["weights"], CPU, state["plans"])
    relu = check.train_numbers(prog, entry.reference_side(spec, *args))
    softplus = {**spec, "config": {**spec["config"], "fea2denseAct": "softplus"}}
    numbers = check.train_numbers(prog, entry.reference_side(softplus, *args))
    ok, table = check.judge(numbers, spec["cell"]["limits"])
    assert not ok and table["loss_gap"]["value"] > table["loss_gap"]["limit"], table
    assert table["loss_gap"]["value"] > 10 * relu["loss_gap"][0]


def test_a_configuration_takes_its_field_module_by_name(tmp_path):
    bench = make_tiny(tmp_path, config=FIXTURES / "fixture-lines.json")
    shutil.copy(FIXTURES / "fixture_lines.py", bench / "reference")
    spec = manifest.cell_spec("tiny.tiny-train", bench)
    field, wd, traffic = spec["field"], scene.widths(spec["config"]), spec["traffic"]
    assert Path(field.__file__) == bench / "reference" / "fixture_lines.py"

    mlp = {"mlp.w1": (27 + 3 + 4 * 27 + 12, 128), "mlp.b1": (128,), "mlp.w2": (128, 128), "mlp.b2": (128,),
           "mlp.w3": (128, 3), "mlp.b3": (3,)}
    lines = {f"{kind}_line_{i}": (r, 32) for kind, r in (("density", 8), ("app", 24)) for i in range(3)}
    assert scene.weight_shapes(field, wd, 32) == {**lines, "basis_mat": (24, 27), **mlp}
    sd = scene.seeds(SEED)
    weights = scene.make_weights(field, wd, 32, sd["weights"], CPU)
    assert {k: tuple(v.shape) for k, v in weights.items()} == scene.weight_shapes(field, wd, 32)
    assert float(weights["density_line_0"].std()) == pytest.approx(0.1, rel=0.2)

    # 11 operations a component of 32 and the density sum of 8; basis
    # 2*24*27; layers 2*150*128+256, 2*128*128+256, 2*128*3+6; encodings
    # 4*(2*27+2*3); compositing 10
    assert flops.point_forward(field, wd) == 11 * 32 + 8 + 1296 + 38656 + 33024 + 774 + 240 + 10
    assert flops.l1_voxel(field, wd) == 0 and flops.k2_bytes(field, wd, 32, 256, 16) is None
    ctx = {"spec": spec, "traced": {"steps": 4},
           "trace": {"window_s": 2.0, "ops": {"void segment_sum_tile_kernel<4>": 0.1}}}
    assert manifest.metric_reader("k2_roofline.train", bench)(ctx) is None
    mfu = manifest.metric_reader("step_mfu.train", bench)(ctx)
    assert mfu == 100.0 * flops.train_step(field, wd, 32, 256, 16) * 4 / (2.0 * flops.PEAK_BF16_FLOP_S)

    # the reference trains with the module's features and L1 term
    frames = scene.make_frames(traffic["frames"], *traffic["wh"], sd["frames"], CPU)
    entry = manifest.entry_module("train", bench)
    ref = entry.reference_side(spec, sd, frames, weights, CPU)
    l1, _ = field.density_l1_grads(weights, wd["act"])
    assert ref["losses"][0]["l1_loss"] == pytest.approx(float(l1) * spec["config"]["L1_weight"], rel=1e-6)
    assert set(ref["grad1"]) == set(weights) | set(POSE_LEAVES)
    assert all(ref["grad1"][k] > 0 for k in weights if k != "mlp.b3")

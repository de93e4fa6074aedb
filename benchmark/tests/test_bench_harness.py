"""The harness on the CPU: the manifest's rules, discovery by name, the
import guard, the operation and byte counts, and the exits without a card."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
from conftest import BENCH, ROOT, make_tiny, run_tiny

from harness import flops, guard, manifest, scene


def test_manifest_names_units_sources_and_cross_references():
    man = manifest.manifest()
    assert manifest.problems(man) == []
    for m in man["end_to_end"] + man["per_layer"]:
        assert manifest.UNIT.match(m["unit"]) and len(m["unit"]) <= 16
    assert not manifest.NAME.match("a b") and not manifest.NAME.match("a/b") and not manifest.NAME.match("µs")
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_each_metric_lists_only_cells_that_report_what_it_moves():
    man = manifest.manifest()
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            assert manifest.applies(e2e[m["moves"]], cell), (m["name"], cell)
    broken = json.loads(json.dumps(man))
    broken["per_layer"][0]["workloads"] = ["localrf-default.eval-640"]
    assert any("does not report" in p for p in manifest.problems(broken))


def test_every_cell_file_configuration_and_metric_reader_is_found():
    man = manifest.manifest()
    for w in man["workloads"]:
        spec = manifest.cell_spec(w["name"])
        assert spec["traffic"]["entry"] in ("train", "eval")
        assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
        assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
        assert spec["cell"]["limits"], w["name"]
        for m in spec["per_layer"]:
            assert callable(manifest.metric_reader(m["name"]))
    for c in man["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")


def test_a_cell_configuration_and_metric_added_as_new_files_are_found_and_run(tmp_path):
    bench = make_tiny(tmp_path)
    (bench / "metrics" / "steps_traced.train.py").write_text(
        "def read(ctx):\n    return float(ctx['traced']['steps'])\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                             "source": "host_clock", "layer": "host schedule (models/local.py plan_chunk)",
                             "moves": "train_rays_per_s", "workloads": ["tiny.tiny-train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    assert manifest.problems(man) == []
    spec = manifest.cell_spec("tiny.tiny-train", bench)
    assert spec["config"]["N_voxel_final"] == 32**3 and spec["traffic"]["grid"] == 32
    assert "steps_traced.train" in {m["name"] for m in spec["per_layer"]}
    traced = run_tiny(bench, "tiny.tiny-train", trace=True)
    chunk = spec["traffic"]["chunk"]
    assert traced["metrics"]["steps_traced.train"]["value"] == chunk * min(2, traced["attempted"] // chunk)
    assert "plan_ms_per_step.train" in traced["metrics"]
    plain = run_tiny(bench, "tiny.tiny-train")
    assert set(plain["metrics"]) == {"train_rays_per_s", "setup_s"}
    assert plain["correct"] and list(plain)[-1] == "checks"


def test_the_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded({"localrf_tpu_torch", "localrf_tpu_torch.models.step"}) == []
    assert guard.forbidden_loaded({"jax.numpy", "numpy"}) == ["jax"]
    assert guard.forbidden_loaded({"localrf_tpu.ops.math", "jaxlib", "flax.linen"}) == ["flax", "jaxlib", "localrf_tpu"]
    assert guard.forbidden_loaded({"jaxtyping", "localrf_tpu_x"}) == []


def _imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_of_the_benchmark_imports_jax_and_the_reference_imports_no_program():
    for path in BENCH.rglob("*.py"):
        assert not _imported_tops(path) & guard.FORBIDDEN, path
    for path in (BENCH / "reference").glob("*.py"):
        assert "localrf_tpu_torch" not in _imported_tops(path), path
    code = ("import sys; sys.path.insert(0, 'benchmark'); import reference.step, reference.render;"
            " print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.replace("'", '"')))
    assert not loaded & (guard.FORBIDDEN | {"localrf_tpu_torch", "harness"})


def test_counts_on_hand_computed_shapes():
    cfg = json.loads((BENCH / "configs" / "localrf-default.json").read_text())
    vm = manifest.field_module(cfg)
    wd = scene.widths(cfg)
    # per orientation 13 operations a channel of 32 and a density sum of 8;
    # basis 2*72*27; layers 2*27*128+256, 2*128*128+256, 2*131*3+6; 10 compositing
    assert flops.point_forward(vm, wd) == 3 * (13 * 32 + 8) + 3888 + 7168 + 33024 + 792 + 10 == 46154
    # PERF.md's K4 count: 45.7k a point forward (the MLP and basis it fuses)
    assert abs(flops.point_forward(vm, wd) / 45.7e3 - 1) < 0.02
    # 640^3, 4096 x 332 points: per plane sum the bf16 payload [P, 128], the
    # int64 ids [P], the bf16 table [409600, 128]: PERF.md's 463.9 MB
    p = 4096 * 332
    per_sum = p * 128 * 2 + p * 8 + 640 * 640 * 128 * 2
    assert per_sum == 463_863_808
    assert flops.k2_bytes(vm, wd, 640, 4096, 332) == 3 * per_sum
    vm192 = scene.widths(json.loads((BENCH / "configs" / "tensorf-vm192.json").read_text()))
    assert flops.k2_bytes(vm, vm192, 300, 4096, 256) == 3 * (4096 * 256 * (256 * 2 + 8) + 300 * 300 * 256 * 2)
    # MLP_Fea: 27 + 3 + 2*2*27 + 2*2*3 = 150 inputs
    assert scene.mlp_shapes(vm192)["1"] == (150, 128)
    assert flops.n_params(vm, wd, 640) == (3 * 32 * 640 * 640 + 3 * 32 * 640 + 72 * 27 + 27 * 128 + 128
                                           + 128 * 128 + 128 + 131 * 3 + 3)
    step = flops.train_step(vm, wd, 640, 4096, 332)
    assert step == 3 * 46154 * 4096 * 332 + 3 * (2 * 24 + 6) * 640**3 + 12 * flops.n_params(vm, wd, 640)


@pytest.mark.parametrize("bare", [False, True])
def test_no_card_or_no_program_exits_non_zero_with_no_result(tmp_path, bare):
    cwd = ROOT
    if bare:
        # a checkout of BENCHMARK.json and the benchmark's folder only
        cwd = tmp_path
        make_tiny(tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "localrf-default.refine-640",
                          "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_trace_arithmetic_on_hand_made_events():
    from harness.trace import breakdown, reduce_events

    ms = 1_000_000
    events = [
        ("bench.plan_chunk", 0, 10 * ms, False), ("bench.run_chunk", 10 * ms, 100 * ms, False),
        ("bench.run_chunk", 10 * ms, 100 * ms, True),  # the span's mirror on the device: no work
        ("k_a", 20 * ms, 50 * ms, True), ("k_b", 40 * ms, 60 * ms, True), ("k_a", 70 * ms, 90 * ms, True),
        ("cudaGraphLaunch", 12 * ms, 13 * ms, False),
    ]
    r = reduce_events(events)
    assert r["window_s"] == pytest.approx(0.1) and r["busy_s"] == pytest.approx(0.06)
    assert r["ops"] == {"k_a": pytest.approx(0.05), "k_b": pytest.approx(0.02)}
    # idle: 0-10 in plan_chunk; 10-20, 60-70, 90-100 in run_chunk
    assert r["gaps"] == {"plan_chunk": pytest.approx(0.01), "run_chunk": pytest.approx(0.03)}
    assert breakdown(r)["device_ops"][0] == ["k_a", pytest.approx(0.05)]
    assert reduce_events([("bench.run_chunk", 0, 5, False)]) is None

"""One run of one benchmark cell of localrf_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads BENCHMARK.json and the cell's files (harness/manifest.py), builds the
program and its inputs from the seed, warms up (set-up), measures for
--seconds, then checks the first steps or a sample of the frames against
the plain reference. Prints, last on standard error, each number compared
beside its limit, and, last on standard output, one JSON line: correct,
attempted, failed, metrics (the cell's end-to-end metrics; with --trace 1
its per-layer metrics), device, with --trace 1 breakdown, and last checks.
Exits non-zero, printing no result, without enough CUDA cards, or when
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import os
import time

T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux /proc), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)


AGE_AT_T0 = _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every compile cache at a fixed place inside the checkout
CACHE = ROOT / "build" / "bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import check, guard, manifest  # noqa: E402
from harness.trace import Spans, breakdown, reduce_trace  # noqa: E402


class Run:
    """One run's settings, its spans and its profiler."""

    def __init__(self, device, seed: int, seconds: float, trace: bool):
        self.device, self.seed, self.seconds, self.trace = device, seed, seconds, trace
        self.spans = Spans()
        self.setup_done = None
        self.profile = None
        self.reduced = None
        self._mark = time.perf_counter()

    def mark(self, phase: str) -> None:
        """Print the seconds since the last mark (or the run's start) on standard error."""
        now = time.perf_counter()
        print(f"setup: {phase} {now - self._mark:.3f} s", file=sys.stderr)
        self._mark = now

    def start_trace(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.profile = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.profile.__enter__()
        self.spans.tracing = True

    def stop_trace(self) -> None:
        if self.spans.tracing:
            self.spans.tracing = False
            self.profile.__exit__(None, None, None)

    def close_window(self) -> None:
        """After the window: reduce the trace of the traced span."""
        if self.profile is not None:
            self.reduced = reduce_trace(self.profile)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device) -> dict:
    """Drive the cell on `device` and return the result line (a dict)."""
    import torch

    run = Run(device, seed, seconds, trace)
    print(f"setup: process start and imports {AGE_AT_T0 + run._mark - T0:.3f} s", file=sys.stderr)
    entry = manifest.entry_module(spec["traffic"]["entry"], spec["bench_dir"])
    out = entry.run(spec, run)
    setup_s = AGE_AT_T0 + (run.setup_done - T0)
    ok, table = check.judge(out["numbers"], spec["cell"].get("limits", {}))
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": out["memory_peak_bytes"],
                   "power_limit": _power_limit() if device.type == "cuda" else None}
    result = {"correct": bool(ok and out["failed"] == 0), "attempted": out["attempted"], "failed": out["failed"]}
    metrics = {}
    if trace:
        reduced = run.reduced
        ctx = {"spec": spec, "traced": out["traced"], "trace": reduced}
        for m in spec["per_layer"]:
            value = manifest.metric_reader(m["name"], spec["bench_dir"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if reduced is not None:
            device_info.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
            result["breakdown"] = breakdown(reduced)
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info
    worst = {k: where for k, (_, where) in out["numbers"].items()}
    result["checks"] = {k: dict(row, where=worst[k]) for k, row in table.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = manifest.cell_spec(args.workload)
    chips = spec["entry"]["chips"]
    if chips != 1:
        print(f"benchmark: {args.workload} asks for {chips} chips; this harness drives one", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print(f"benchmark: {args.workload} needs a CUDA card, found none", file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = guard.forbidden_loaded()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r} ({row['where']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

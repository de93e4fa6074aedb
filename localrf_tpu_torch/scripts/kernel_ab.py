"""Time K1, K2, K3, K4 and K5 of two checkouts on one card, in turns.

    python3 localrf_tpu_torch/scripts/kernel_ab.py --parent DIR [--chunks]

DIR holds another checkout of the repository (for example the parent
commit, unpacked with `git archive` into a directory that .gitignore
lists). The script records the plane indices of one real training step at
64^3 and 640^3 and the line indices of one real 640^3 segsum step with
this checkout (chip_smoke.real_plane_indices, real_line_indices), then
runs itself as a worker four times, parent, this checkout, this checkout,
parent, each on the same inputs: K1 forward and backward at [4096, 72]
(the shared [1, 72] dist row) and [4096, 332] (per-ray dists), K2
bf16 -> bf16 on uniform and real-step indices at both plane shapes, K3
bf16 -> f32 on uniform indices at 64 and 640 line rows and on the
real-step line indices, K5 bf16 -> bf16 on K2's inputs and on the step's
other two plane sums ("real step" is the first of three), and K4
forward and backward (bf16 tables and MLP, chip_smoke.march_inputs of that
checkout: G 64, P 4096 x 72 and G 640, P 4096 x 332, line rows x0 drawn
uniformly; K4-bwd also with x0 sorted within each ray's samples, as a
march gives them). A time is a CUDA graph of 20 calls (K4: 10) replayed
(as a captured training step launches them), per call; each worker also
lists the device time of every CUDA kernel a K2, K3, K5 or K4-bwd call
ran (torch.profiler). With --chunks each worker also trains
the chunk path through that checkout's chip_smoke helpers (a 146-slot
pixel pool, chunks of 16 replayed CUDA graphs): at 64^3 and at 640^3 on the
default, the fused-march and the segsum-lines paths, and at 640^3 on the
default path with every sum in a fixed order (that checkout's
deterministic_sums: the plane gathers' VJP through K5, three calls a
step), one chunk to capture, then 3 timed
(ms/step, host clock ending in a synchronize) with the peak allocated
bytes. Prints the card, one JSON line per worker, and the mean of each
checkout's two workers. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
REPS = 20


def graph_ms(fn, reps: int = REPS) -> float:
    """Device ms per call: `reps` calls captured in one CUDA graph, replayed
    three times after a warm-up."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def kernel_us(fn, reps: int = 5) -> dict:
    """Device microseconds per call of each CUDA kernel `fn` ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name().removeprefix("void ").replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1]
            out[name] += e.duration_ns() / 1e3 / reps
    return {k: round(v, 2) for k, v in out.most_common()}


def worker(root: str, indices: str) -> dict:
    """K1, K2, K3, K4 and K5 of the checkout at `root`: graph-replay ms per
    case, and the device us of each kernel of a K2, K3, K5 or K4-bwd call."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from localrf_tpu_torch.ops.kernels import binned_scatter as k2
    from localrf_tpu_torch.ops.kernels import composite as k1
    from localrf_tpu_torch.ops.kernels import march as k4
    from localrf_tpu_torch.ops.kernels import segsum as k3

    for mod in (k2, k3, cs):
        if not pathlib.Path(mod.__file__).resolve().is_relative_to(pathlib.Path(root).resolve()):
            raise RuntimeError(f"imported {mod.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    real = torch.load(indices, map_location=dev)
    times, kernels = {}, {}
    for label, r, s, per_ray in (("[4096,72]", 4096, 72, False), ("[4096,332]", 4096, 332, True)):
        sigma = 2.0 * torch.rand(r, s, generator=gen, device=dev)
        dists = 0.01 + 0.49 * torch.rand(r if per_ray else 1, s, generator=gen, device=dev)
        cot = torch.randn(r, s, generator=gen, device=dev)
        with torch.cuda.device(dev):
            times[f"K1-fwd {label}"] = graph_ms(lambda: k1._launch_fwd(sigma, dists, 25.0))
            times[f"K1-bwd {label}"] = graph_ms(lambda: k1._launch_bwd(sigma, dists, cot, 25.0))
    for label, n_rows, p in (("64^3", 4096, 4096 * 72), ("640^3", 409_600, 4096 * 332)):
        g = torch.randn(p, 128, generator=gen, device=dev).to(torch.bfloat16)
        uniform = torch.randint(0, n_rows, (p,), generator=gen, device=dev)
        for kind, idx in (("uniform", uniform), ("real step", real[label])):
            key = f"K2 {label} {kind}"
            times[key] = graph_ms(lambda: k2.segment_sum(idx, g, n_rows, torch.bfloat16))
            kernels[key] = kernel_us(lambda: k2.segment_sum(idx, g, n_rows, torch.bfloat16))
        for kind, idx in (("uniform", uniform), ("real step", real[label]),
                          ("real step sum 1", real[f"{label} sum 1"]), ("real step sum 2", real[f"{label} sum 2"])):
            key = f"K5 {label} {kind}"
            times[key] = graph_ms(lambda: k2.binned_segment_sum_merged(idx, g, n_rows, torch.bfloat16))
            kernels[key] = kernel_us(lambda: k2.binned_segment_sum_merged(idx, g, n_rows, torch.bfloat16))
    for label, n_rows, p in (("64^3", 64, 4096 * 72), ("640^3", 640, 4096 * 332)):
        g = torch.randn(p, 64, generator=gen, device=dev).to(torch.bfloat16)
        cases = [("uniform", torch.randint(0, n_rows, (p,), generator=gen, device=dev))]
        if label == "640^3":
            cases.append(("real step", real["lines 640^3"]))
        for kind, idx in cases:
            key = f"K3 {label} {kind}"
            times[key] = graph_ms(lambda: k3.segment_sum_small(idx, g, n_rows))
            kernels[key] = kernel_us(lambda: k3.segment_sum_small(idx, g, n_rows))
    for label, g_rows, s in (("64^3", 64, 72), ("640^3", 640, 332)):
        args, gout = cs.march_inputs(g_rows, 4096 * s, torch.bfloat16, torch.Generator(device=dev).manual_seed(1), dev)
        plain = [a.detach() for a in args]
        times[f"K4-fwd {label}"] = graph_ms(lambda: k4._launch_fwd(plain, "bfloat16"), reps=10)
        times[f"K4-bwd {label}"] = graph_ms(lambda: k4._launch_bwd(plain, gout, "bfloat16"), reps=10)
        kernels[f"K4-bwd {label}"] = kernel_us(lambda: k4._launch_bwd(plain, gout, "bfloat16"))
        # x0 ascending along each ray's samples: runs of equal line rows
        plain[5] = plain[5].view(4096, s, 3).sort(dim=1).values.reshape(-1, 3).contiguous()
        key = f"K4-bwd {label} ray-sorted x0"
        times[key] = graph_ms(lambda: k4._launch_bwd(plain, gout, "bfloat16"), reps=10)
        kernels[key] = kernel_us(lambda: k4._launch_bwd(plain, gout, "bfloat16"))
        del args, plain, gout
        torch.cuda.empty_cache()
    return {"root": root, "ms": times, "kernel_us": kernels}


def chunk_worker(root: str) -> dict:
    """ms/step and peak bytes of the chunk path at 64^3 and 640^3 (default,
    fused march, segsum lines, and default with fixed-order sums), through
    the chip_smoke helpers of the checkout at `root`."""
    import torch

    import chip_smoke as cs
    from localrf_tpu_torch.data.pool import DevicePixelPool
    from localrf_tpu_torch.models.local import LocalTensorfs

    if not pathlib.Path(cs.__file__).resolve().is_relative_to(pathlib.Path(root).resolve()):
        raise RuntimeError(f"imported {cs.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ds = cs.make_dataset(cs.W, cs.H, cs.N_FRAMES)
    pool = DevicePixelPool(ds, capacity=cs.POOL_SLOTS, device=dev)
    out = {}
    for label in ("64^3", "640^3 default", "640^3 fused_march", "640^3 segsum",
                  "640^3 default fixed-order"):
        fixed = cs.deterministic_sums() if label.endswith("fixed-order") else contextlib.nullcontext()
        if label == "64^3":
            model = LocalTensorfs(cs.full_width_config(64), device=dev)
            model.is_refining = True
            model.rf_iter[-1] = 2
        else:
            model = cs.model_640(dev, label.split()[1])
        model.attach_pool(pool)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with fixed:
            cs._run_chunk(model, model.plan_chunk(ds, True, cs.CHUNK))  # warm-up and capture
            times = [cs._run_chunk(model, model.plan_chunk(ds, True, cs.CHUNK)) / cs.CHUNK for _ in range(3)]
        out[label] = {"ms_per_step": sorted(times)[1], "all": times,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del model
        torch.cuda.empty_cache()
    return out


def record_indices(path: pathlib.Path) -> None:
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke

    dev = torch.device("cuda", 0)
    ds = chip_smoke.make_dataset(chip_smoke.W, chip_smoke.H, chip_smoke.N_FRAMES)
    real = {}
    for label, sums in chip_smoke.real_plane_indices(dev, ds).items():
        real.update({label if k == 0 else f"{label} sum {k}": idx for k, (idx, _) in enumerate(sums)})
    real["lines 640^3"] = chip_smoke.real_line_indices(dev, ds)[0]
    torch.save(real, path)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another checkout to time against this one")
    ap.add_argument("--chunks", action="store_true", help="also time the chunk path")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--indices", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        result = worker(args.worker, args.indices)
        if args.chunks:
            result["chunks"] = chunk_worker(args.worker)
        print(json.dumps(result))
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device")
    if not args.parent:
        sys.exit("kernel_ab: --parent DIR is needed")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    indices = REPO / "build" / "kernel_ab_indices.pt"
    indices.parent.mkdir(exist_ok=True)
    record_indices(indices)
    parent = str(pathlib.Path(args.parent).resolve())
    runs = []
    for root in (parent, str(REPO), str(REPO), parent):
        cmd = [sys.executable, __file__, "--worker", root, "--indices", str(indices)]
        out = subprocess.run(cmd + ["--chunks"] * args.chunks, capture_output=True, text=True, cwd=root)
        if out.returncode:
            raise RuntimeError(f"worker {root} failed:\n{out.stderr[-4000:]}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    rows = [(name, lambda r, name=name: r["ms"][name], "ms") for name in runs[0]["ms"]]
    for label in runs[0].get("chunks", {}):
        rows.append((f"chunk {label}", lambda r, k=label: r["chunks"][k]["ms_per_step"], "ms/step"))
        rows.append((f"chunk {label} peak", lambda r, k=label: r["chunks"][k]["peak_gib"], "GiB"))
    for name, get, unit in rows:
        a = sorted(get(r) for r in runs if r["root"] == parent)
        b = sorted(get(r) for r in runs if r["root"] == str(REPO))
        print(f"{name:28s} parent {sum(a) / 2:.4f} {unit} ({a[0]:.4f}, {a[1]:.4f})"
              f"  this {sum(b) / 2:.4f} {unit} ({b[0]:.4f}, {b[1]:.4f})")


if __name__ == "__main__":
    main()

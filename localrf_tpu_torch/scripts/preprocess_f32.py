"""What full f32 costs the preprocessing networks on the card, and what TF32
would change: shows that chip_smoke's card-vs-CPU checks of the preprocess
phase can see TF32, and why DPT convolves without cuDNN.

1. Errors against the port on the CPU: RAFT on chip_smoke's pair (frames
   0 and 1 of its seeded 960x540 scene at scale 0.5, padded to 2 x 480x272,
   30 iterations, init_raft seed 0), DPT-Large on its 384x384 input
   (init_dpt seed 1), SSIM and LPIPS of two 960x540 frames: each on the card
   as the port runs it (full f32: ops/math.py::full_f32) and with cuDNN's
   and cuBLAS's TF32 allowed (the same code without its scopes).
2. Times (CUDA events, mean of 3 calls after a warm-up) and peak memory of
   RAFT and DPT-Large as the port runs them, with TF32 allowed, and for
   DPT in full f32 through cuDNN; and of DPT-Large's head conv alone (3x3,
   256 -> 128 channels at 192x192) through cuDNN in full f32, without cuDNN
   in full f32, and through cuDNN with TF32.
3. One forward of RAFT and of DPT-Large as the port runs them under
   torch.profiler: the kernels launched and their device ms beside the
   host ms of the call.

Prints the card's name and power limit and one JSON line.

    python3 localrf_tpu_torch/scripts/preprocess_f32.py    (one card, ~1 min)
"""
from __future__ import annotations

import contextlib
import inspect
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]


@contextlib.contextmanager
def tf32_allowed():
    import torch

    conv, matmul = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    saved = conv.fp32_precision, matmul.fp32_precision
    conv.fp32_precision = matmul.fp32_precision = "tf32"
    try:
        yield
    finally:
        conv.fp32_precision, matmul.fp32_precision = saved


def main() -> None:
    import cv2
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("preprocess_f32: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from localrf_tpu_torch.ops.math import full_f32
    from localrf_tpu_torch.preprocess.dpt import DPT, DPTConfig, init_dpt
    from localrf_tpu_torch.preprocess.raft import RAFT, InputPadder, init_raft
    from localrf_tpu_torch.utils import lpips, metrics

    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    print(cs._gpu_line())
    out: dict = {"err": {}, "ms": {}, "peak_gib": {}, "profile": {}}

    def timed(name, fn):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out["ms"][name] = cs._time_ms(fn, 3, eager=True)
        out["peak_gib"][name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        print(f"{name}: {out['ms'][name]:.3f} ms a call, {out['peak_gib'][name]:.3f} GiB above its inputs")

    with tempfile.TemporaryDirectory() as tmp:
        cs.write_scene(tmp, cs.W, cs.H, 2, images_only=True)
        frames = [cv2.imread(f"{tmp}/images/{i:06d}.jpg")[..., ::-1] for i in (0, 1)]
    half = [torch.from_numpy(cv2.resize(f, None, fx=0.5, fy=0.5, interpolation=cv2.INTER_AREA)
                             .astype(np.float32)).permute(2, 0, 1) for f in frames]
    padder = InputPadder(half[0].shape)
    a, b = padder.pad(torch.stack(half)), padder.pad(torch.stack(half[::-1]))
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (1, 3, 384, 384)).astype(np.float32))

    def profiled(name, fn):
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
                   and not e.key.startswith(("Activity Buffer", "Buffer Flush"))]
        out["profile"][name] = {"kernels": sum(e.count for e in kernels), "host_ms": host_ms,
                                "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3}
        p = out["profile"][name]
        print(f"{name} profiled: {p['kernels']} kernels, {p['device_ms']:.2f} device ms in {host_ms:.2f} host ms")

    def errors(name, ref, full, tf32):
        out["err"][name] = {"scale": float(ref.abs().max()), "full_f32": float((full - ref).abs().max()),
                            "tf32": float((tf32 - ref).abs().max())}
        e = out["err"][name]
        print(f"{name}: card vs CPU max err in full f32 {e['full_f32']:.3e}, with TF32 allowed {e['tf32']:.3e}"
              f" (scale {e['scale']:.4f})")

    # RAFT
    raft_cpu = init_raft(torch.Generator().manual_seed(0), device=cpu)
    raft = init_raft(torch.Generator().manual_seed(0), device=dev)
    raw_raft = inspect.unwrap(RAFT.forward)
    a_dev, b_dev = a.to(dev), b.to(dev)
    with torch.no_grad(), tf32_allowed():
        tf32 = raw_raft(raft, a_dev, b_dev, 30).cpu()
    errors("raft", raft_cpu(a, b, 30), raft(a_dev, b_dev, 30).cpu(), tf32)
    timed("raft", lambda: raft(a_dev, b_dev, 30))
    profiled("raft", lambda: raft(a_dev, b_dev, 30))
    with torch.no_grad(), tf32_allowed():
        timed("raft tf32", lambda: raw_raft(raft, a_dev, b_dev, 30))
    del raft, raft_cpu

    # DPT-Large: the port (full f32, no cuDNN), full f32 through cuDNN, TF32
    cfg = DPTConfig.large()
    dpt_cpu = init_dpt(cfg, torch.Generator().manual_seed(1), device=cpu)
    dpt = DPT(cfg).to(dev)
    dpt.load_state_dict(dpt_cpu.state_dict())
    raw_dpt = inspect.unwrap(DPT.forward)
    x_dev = x.to(dev)
    with torch.no_grad(), tf32_allowed():
        tf32 = raw_dpt(dpt, x_dev).cpu()
    errors("dpt_large", dpt_cpu(x), dpt(x_dev).cpu(), tf32)
    del dpt_cpu
    timed("dpt_large", lambda: dpt(x_dev))
    profiled("dpt_large", lambda: dpt(x_dev))
    with torch.no_grad(), full_f32():
        timed("dpt_large full f32 through cuDNN", lambda: raw_dpt(dpt, x_dev))
    with torch.no_grad(), tf32_allowed():
        timed("dpt_large tf32", lambda: raw_dpt(dpt, x_dev))
    del dpt

    g = torch.Generator(device=dev).manual_seed(0)
    hx = torch.randn(1, 256, 192, 192, device=dev, generator=g)
    hw = torch.randn(128, 256, 3, 3, device=dev, generator=g)
    with torch.no_grad():
        with full_f32():
            timed("head conv full f32 through cuDNN", lambda: F.conv2d(hx, hw, padding=1))
            torch.backends.cudnn.enabled = False
            try:
                timed("head conv full f32 without cuDNN", lambda: F.conv2d(hx, hw, padding=1))
            finally:
                torch.backends.cudnn.enabled = True
        with tf32_allowed():
            timed("head conv tf32 through cuDNN", lambda: F.conv2d(hx, hw, padding=1))

    # SSIM and LPIPS of two frames; with TF32 allowed, without their scopes
    img0, img1 = (torch.from_numpy(np.ascontiguousarray(f, np.float32) / 255) for f in frames)
    on_card = [i.to(dev) for i in (img0, img1)]
    scoped = metrics.full_f32
    metrics.full_f32 = contextlib.nullcontext  # rgb_ssim's scope, looked up at each call
    try:
        with tf32_allowed():
            tf32 = metrics.rgb_ssim(*on_card, 1.0)
    finally:
        metrics.full_f32 = scoped
    errors("ssim", torch.tensor(metrics.rgb_ssim(img0, img1, 1.0)),
           torch.tensor(metrics.rgb_ssim(*on_card, 1.0)), torch.tensor(tf32))
    with torch.no_grad(), tf32_allowed():
        tf32 = float(inspect.unwrap(lpips.lpips_nchw)(
            lpips.get_params(dev), *(lpips._nchw(i, dev) * 2 - 1 for i in on_card))[0])
    errors("lpips", torch.tensor(metrics.rgb_lpips(img0, img1)), torch.tensor(metrics.rgb_lpips(*on_card)),
           torch.tensor(tf32))
    print(cs._gpu_line())
    print(json.dumps({"preprocess_f32": out, "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()

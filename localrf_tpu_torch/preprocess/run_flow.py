"""Flow preprocessing CLI: RAFT forward and backward flow with
cycle-consistency masks (the port of localrf_tpu/preprocess/run_flow.py).

Adjacent frame pairs at 0.5 scale, the forward and backward flow of a pair
in one batch of two, 30 refinement iterations, cycle-consistency masks
(alpha_1 = 0.05, alpha_2 = 0.5), uint16-encoded `flow_ds/*.png` (the flow
from frame i to i+1 as `fwd_<i+1>.png`, from i+1 to i as `bwd_<i>.png`)
and `flow_vis/` colour JPGs. RAFT runs on `--device` (default cuda); the
masks and files are made on the host.

Usage:
  python -m localrf_tpu_torch.preprocess.run_flow --data_dir <scene> \\
      [--ckpt weights/raft-things.pth] [--frame_step N] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.flow_io import encode_flow
from .flow_vis import flow_to_color


def compute_fwdbwd_mask(fwd_flow, bwd_flow, alpha_1=0.05, alpha_2=0.5):
    """Cycle-consistency masks: |f + b(x+f)|^2 < a1 * (|f|^2 + |b(x+f)|^2) + a2
    for both directions (ref: scripts/run_flow.py:31-43). [H, W, 2] numpy
    flows -> two [H, W] bool masks."""
    import cv2

    h, w = fwd_flow.shape[:2]
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    grid = np.stack([gx, gy], axis=-1).astype(np.float32)

    def warp(flow_target, flow_by):
        coords = grid + flow_by
        return cv2.remap(flow_target, coords[..., 0], coords[..., 1], cv2.INTER_LINEAR)

    bwd2fwd = warp(bwd_flow, fwd_flow)
    fwd_err = np.sum((fwd_flow + bwd2fwd) ** 2, axis=-1)
    fwd_mask = fwd_err < alpha_1 * (np.sum(fwd_flow**2, -1) + np.sum(bwd2fwd**2, -1)) + alpha_2

    fwd2bwd = warp(fwd_flow, bwd_flow)
    bwd_err = np.sum((bwd_flow + fwd2bwd) ** 2, axis=-1)
    bwd_mask = bwd_err < alpha_1 * (np.sum(bwd_flow**2, -1) + np.sum(fwd2bwd**2, -1)) + alpha_2
    return fwd_mask, bwd_mask


def main(argv=None):
    import cv2

    from .convert import load_raft_checkpoint
    from .raft import InputPadder

    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--ckpt", default="weights/raft-things.pth")
    parser.add_argument("--frame_step", type=int, default=1)
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument("--scale", type=float, default=0.5)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    dev = torch.device(args.device)
    model = load_raft_checkpoint(args.ckpt, device=dev)

    img_dir = os.path.join(args.data_dir, "images")
    names = sorted(os.listdir(img_dir))
    step = args.frame_step
    prefix = f"step{step}_" if step != 1 else ""
    flow_dir = os.path.join(args.data_dir, "flow_ds")
    vis_dir = os.path.join(args.data_dir, "flow_vis")
    os.makedirs(flow_dir, exist_ok=True)
    os.makedirs(vis_dir, exist_ok=True)

    def load(name):
        img = cv2.imread(os.path.join(img_dir, name))[..., ::-1]
        img = cv2.resize(img, None, fx=args.scale, fy=args.scale, interpolation=cv2.INTER_AREA)
        return torch.from_numpy(img.astype(np.float32)).permute(2, 0, 1)

    for i in range(0, len(names) - step, step):
        n1, n2 = names[i], names[i + step]
        im1, im2 = load(n1), load(n2)
        padder = InputPadder(im1.shape)
        # fwd and bwd share one batched inference (ref batch-of-2 trick)
        a = padder.pad(torch.stack([im1, im2]).to(dev))
        b = padder.pad(torch.stack([im2, im1]).to(dev))
        flows = padder.unpad(model(a, b, iters=args.iters)).permute(0, 2, 3, 1).cpu().numpy()
        fwd, bwd = flows[0], flows[1]

        fwd_mask, bwd_mask = compute_fwdbwd_mask(fwd, bwd)
        base1 = os.path.splitext(n1)[0]
        base2 = os.path.splitext(n2)[0]
        cv2.imwrite(os.path.join(flow_dir, f"fwd_{prefix}{base2}.png"), encode_flow(fwd, fwd_mask))
        cv2.imwrite(os.path.join(flow_dir, f"bwd_{prefix}{base1}.png"), encode_flow(bwd, bwd_mask))
        cv2.imwrite(os.path.join(vis_dir, f"fwd_{prefix}{base2}.jpg"), flow_to_color(fwd)[..., ::-1])
        cv2.imwrite(os.path.join(vis_dir, f"bwd_{prefix}{base1}.jpg"), flow_to_color(bwd)[..., ::-1])
        if i % 20 == 0:
            print(f"flow {i}/{len(names)}")


if __name__ == "__main__":
    main()

"""Offline full-frame renderer and evaluator (PyTorch port of
localrf_tpu/renderer.py; ref: renderer.py:16-190).

A host loop over LocalTensorfs.forward_eval: per-frame RGB and depth maps,
MSE / SSIM / LPIPS against the test frames, the flow and depth comparison
panels, pose wireframes, PNG/JPG frames and mp4 videos. A frame's tensors
stay on the model's device (the metrics, the predicted flow and the depth
panel's normalization are computed there) until the frame is written.
Videos go through cv2.VideoWriter ("mp4v"); where no writer opens, the
frames are still written as images.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .ops.math import compute_depth_loss, get_fwd_bwd_cam2cams, get_pred_flow
from .utils.metrics import lpips_backbone, rgb_lpips, rgb_ssim
from .utils.vis import draw_poses, to_uint8, visualize_depth


def _flow_panel(pred: np.ndarray, gt_flow: np.ndarray, gt_mask: np.ndarray, w: int, h: int) -> np.ndarray:
    """Predicted over ground-truth flow per channel (each scaled by its 0.9
    quantile), above the masked error (ref: renderer.py:79-116)."""
    import cv2

    gt_flow = cv2.resize(gt_flow, (w, h), interpolation=cv2.INTER_NEAREST)
    gt_mask = cv2.resize(gt_mask.astype(np.float32), (w, h), interpolation=cv2.INTER_NEAREST)
    cols = []
    for c in range(2):
        cmp_c = np.vstack([pred[..., c], gt_flow[..., c]])
        q = np.quantile(cmp_c, 0.9)
        cmp_c = cmp_c / (q if q != 0 else 1.0)
        err = np.abs(pred[..., c] - gt_flow[..., c]) * gt_mask / w
        cols.append(np.vstack([cmp_c, err]))
    return np.clip(np.hstack(cols), 0, 1)


def _write_video(path: str, frames: list[np.ndarray], fps: int = 30) -> None:
    """RGB uint8 frames -> an mp4 (cv2's "mp4v" writer)."""
    import cv2

    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError("cv2.VideoWriter could not open an mp4v writer")
    try:
        for f in frames:
            writer.write(np.ascontiguousarray(f[..., ::-1]))
    finally:
        writer.release()


def render(
    test_dataset,
    poses_mtx: np.ndarray,
    local_tensorfs,
    args,
    w: int,
    h: int,
    frame_indices=None,
    save_path: str | None = None,
    save_video: bool = False,
    save_frames: bool = False,
    test: bool = False,
    train_dataset=None,
    world2rf=None,
    img_format: str = "jpg",
    annotate: bool = False,
    save_raw_depth: bool = False,
    start: int = 0,
    floater_thresh: float = 0.0,
    add_frame_to_list: bool = True,
):
    """Render the test frames (`test`) or the poses `poses_mtx`; returns the
    lists (rgb maps, depth maps, ground truths, fwd / bwd flow panels,
    depth panels; host arrays) and the metrics {fbase: {"mse", "ssim",
    "lpips" or "lpips_randinit", "lpips_backbone"}}, as JAX's render."""
    import cv2

    model = local_tensorfs
    dev = model.device
    rgb_maps_tb, depth_maps_tb, gt_rgbs_tb, poses_vis = [], [], [], []
    fwd_flow_cmp_tb, bwd_flow_cmp_tb, depth_cmp_tb = [], [], []

    if test:
        idxs = [train_dataset.all_fbases[fb] for fb in test_dataset.all_fbases]
        idxs = [i for i in idxs if start <= i < poses_mtx.shape[0]]
    else:
        poses_mtx = poses_mtx[start:]
        idxs = list(range(poses_mtx.shape[0]))
        is_test_id = [fb in test_dataset.all_fbases for fb in train_dataset.all_fbases]
        if frame_indices is None:
            # nearest train pose per rendered pose for the blending weights
            # (ref: renderer.py:45-52)
            t_c2w = model.get_cam2world()[:, :, 3]
            frame_indices = np.array(
                [int(np.argmin(np.linalg.norm(t_c2w - pose[None, :, 3], axis=-1))) for pose in poses_mtx]
            )

    rays_ids = np.arange(w * h, dtype=np.int64)
    metrics = {}
    for i, idx in enumerate(idxs):
        if test:
            view_ids = np.array([idx])
            cam2world = None
        else:
            view_ids = np.array([int(frame_indices[idx])])
            cam2world = poses_mtx[i][None]

        rgb_map, depth_map, directions, ij = model.forward_eval(
            rays_ids, view_ids, w, h, cam2world=cam2world, world2rf=world2rf,
            test_id=test or is_test_id[int(view_ids[0])], chunk=args.batch_size,
            floater_thresh=floater_thresh,
        )

        if test and add_frame_to_list:
            fbase = train_dataset.get_frame_fbase(idx)
            ti = test_dataset.all_fbases[fbase]
            if test_dataset.all_fwd_flow is not None:
                # flow comparison panels (ref: renderer.py:79-116)
                c2w_all = torch.from_numpy(model.get_cam2world()).to(dev)
                fwd_c2c, bwd_c2c = get_fwd_bwd_cam2cams(c2w_all, torch.from_numpy(view_ids).to(dev))
                pts = directions[None] * depth_map[None, :, None]
                focal = model.focal(w)
                center = torch.from_numpy(model.center(w, h)).to(dev)
                pred_fwd, pred_bwd = (
                    get_pred_flow(pts, ij[None], c2c, focal, center).reshape(h, w, 2).cpu().numpy()
                    for c2c in (fwd_c2c, bwd_c2c))
                fwd_flow_cmp_tb.append(
                    _flow_panel(pred_fwd, test_dataset.all_fwd_flow[ti], test_dataset.all_fwd_mask[ti], w, h))
                bwd_flow_cmp_tb.append(
                    _flow_panel(pred_bwd, test_dataset.all_bwd_flow[ti], test_dataset.all_bwd_mask[ti], w, h))
            if test_dataset.all_invdepths is not None:
                # depth normalization error panel (ref: renderer.py:118-124)
                inv = cv2.resize(test_dataset.all_invdepths[ti], (w, h), interpolation=cv2.INTER_NEAREST)
                dyn_n, gt_n, err = compute_depth_loss(
                    1.0 / torch.clamp(depth_map[None], min=1e-6),
                    torch.from_numpy(np.ascontiguousarray(inv, np.float32)).reshape(1, -1).to(dev),
                )
                panel = torch.cat([0.5 * dyn_n[0].reshape(h, w), 0.5 * gt_n[0].reshape(h, w),
                                   err[0].reshape(h, w)])
                depth_cmp_tb.append(torch.clamp(panel, 0, 1).cpu().numpy())

        rgb_map = rgb_map.reshape(h, w, 3)
        depth_map = depth_map.reshape(h, w)
        depth_map_vis, _ = visualize_depth(depth_map, [0, 5])

        if annotate:
            # frame id and contributing fields (ref: renderer.py:131-142)
            img8 = to_uint8(rgb_map).copy()
            weights = model.blending_weights[int(view_ids[0])]
            rf_ids = np.nonzero(weights)[0].tolist()
            wvals = [round(float(weights[r]), 1) for r in rf_ids]
            for text, ypos in ((f"id: {idx}", h - 70), (f"RFs: {rf_ids}", h - 40), (f"W: {wvals}", h - 10)):
                cv2.putText(img8, text, (1, ypos), cv2.FONT_HERSHEY_SIMPLEX, 0.8, (255, 255, 255), 2,
                            cv2.LINE_AA)
            rgb_map = torch.from_numpy(img8).to(dev).float() / 255

        all_poses = np.concatenate([poses_mtx, poses_mtx[min(idx, len(poses_mtx) - 1)][None]], 0)
        pose_vis = draw_poses(all_poses, ["C1"] * poses_mtx.shape[0] + ["C2"])
        pose_vis = cv2.resize(pose_vis, (int(pose_vis.shape[1] * h / pose_vis.shape[0]), h))

        rgb_host = rgb_map.cpu().numpy()
        if add_frame_to_list or (save_video and save_path is not None):
            rgb_maps_tb.append(rgb_host)
            depth_maps_tb.append(depth_map_vis)
            poses_vis.append(pose_vis)

        fbase = f"{i:06d}"
        if test:
            fbase = train_dataset.get_frame_fbase(idx)
            gt = test_dataset.all_rgbs[test_dataset.all_fbases[fbase]]
            if gt.ndim == 1 or gt.shape[:2] != (h, w):
                gt = gt.reshape(test_dataset.img_wh[1], test_dataset.img_wh[0], 3)
                gt = cv2.resize(gt, (w, h))
            if add_frame_to_list:
                gt_rgbs_tb.append(gt)
            gt_dev = torch.from_numpy(np.ascontiguousarray(gt, np.float32)).to(dev)
            # without official weights the random-backbone distance is
            # reported under a distinct key (ref logs LPIPS at eval too,
            # utils/utils.py:210-226)
            lpips_key = "lpips" if lpips_backbone() == "pretrained" else "lpips_randinit"
            metrics[fbase] = {
                "mse": float(torch.mean((gt_dev - rgb_map) ** 2)),
                "ssim": rgb_ssim(gt_dev, rgb_map, 1),
                lpips_key: rgb_lpips(gt_dev, rgb_map),
                "lpips_backbone": lpips_backbone(),
            }

        if save_frames and save_path is not None:
            os.makedirs(f"{save_path}/rgb_maps", exist_ok=True)
            os.makedirs(f"{save_path}/depth_maps", exist_ok=True)
            cv2.imwrite(f"{save_path}/rgb_maps/{fbase}.{img_format}", to_uint8(rgb_host[..., ::-1]))
            cv2.imwrite(f"{save_path}/rgb_maps/{fbase}_pose.{img_format}", pose_vis[..., ::-1])
            cv2.imwrite(f"{save_path}/depth_maps/{fbase}.{img_format}", depth_map_vis[..., ::-1])
            if save_raw_depth:
                cv2.imwrite(f"{save_path}/depth_maps/{fbase}.tiff", depth_map.cpu().numpy())

    if save_video and save_path is not None:
        os.makedirs(save_path, exist_ok=True)
        for name, frames in (
            ("video", [to_uint8(f) for f in rgb_maps_tb]),
            ("posevideo", poses_vis),
            ("depthvideo", depth_maps_tb),
        ):
            if frames:
                try:
                    _write_video(f"{save_path}/{name}.mp4", frames)
                except (RuntimeError, cv2.error) as e:  # frames are still saved as images
                    print(f"mp4 export skipped ({name}): {e}")

    # release the retired fields' device copies made during this render
    model.clear_eval_cache()

    return (rgb_maps_tb, depth_maps_tb, gt_rgbs_tb, fwd_flow_cmp_tb, bwd_flow_cmp_tb, depth_cmp_tb, metrics)

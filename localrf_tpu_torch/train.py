"""Training entry point: progressive reconstruction and the render-only entry
(PyTorch port of localrf_tpu/train.py; ref: train.py:206-642).

The reference's `reconstruction(args)` state machine: the speed-up
rescaling, dataset and model set-up (or a resume from a checkpoint), the
sample -> step -> losses -> progressive-events loop (chunks of replayed
CUDA graphs over a device pixel pool by default), TensorBoard logging,
periodic eval with a tmp checkpoint, and the final outputs
(`checkpoints.th`, `transforms.json`, test renders, smoothed-spline path
renders and videos). Everything runs on `--device` (default cuda).

Run:  python -m localrf_tpu_torch.train --datadir <scene> --logdir <out> [--config f]
      [--device cpu] [--resume 1] [--render_only 1 --ckpt <file>]

Ray-batch data parallelism over N ranks (`--data_parallel`: 0, the
default, is the launch's world size):
      python -m torch.distributed.run --nproc_per_node N -m localrf_tpu_torch.train ...
Each rank is one process, NCCL on cuda:LOCAL_RANK for `--device cuda`,
gloo for `cpu`. Every rank trains, evaluates and renders (eval frames split
over the ranks); only rank 0 writes TensorBoard logs, checkpoints,
transforms.json, frames and videos, while the others wait at a barrier.
"""
from __future__ import annotations

import json
import os
import shlex
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .checkpoint import load_checkpoint, save_checkpoint
from .config import INERT_FLAGS, config_parser
from .data.dataset import LocalRFDataset
from .data.pool import DevicePixelPool
from .models.local import LocalConfig, LocalTensorfs
from .models.tensorf import TensorfConfig
from .ops.math import n_to_reso
from .parallel.sharding import make_mesh
from .renderer import render
from .utils.spline import smooth_poses_spline
from .utils.vis import draw_poses


def save_transforms(poses_mtx, transform_path, local_tensorfs, train_dataset=None):
    """NeRF-style transforms.json export (ref: train.py:29-60)."""
    if train_dataset is not None:
        fnames = train_dataset.all_image_paths
    else:
        fnames = [f"{i:06d}.jpg" for i in range(len(poses_mtx))]

    fl = local_tensorfs.focal(local_tensorfs.W)
    transforms = {
        "fl_x": float(fl),
        "fl_y": float(fl),
        "k1": 0.0,
        "k2": 0.0,
        "p1": 0.0,
        "p2": 0.0,
        "cx": local_tensorfs.W / 2,
        "cy": local_tensorfs.H / 2,
        "w": local_tensorfs.W,
        "h": local_tensorfs.H,
        "frames": [],
    }
    for pose_mtx, fname in zip(poses_mtx, fnames):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :] = pose_mtx
        transforms["frames"].append(
            {
                "file_path": f"images/{fname}",
                "sharpness": 75.0,
                "transform_matrix": pose.tolist(),
            }
        )
    with open(transform_path, "w") as f:
        json.dump(transforms, f, indent=2)


def _rank0(mesh) -> bool:
    """Whether this rank writes files: rank 0 of a mesh, or the only rank."""
    return mesh is None or dist.get_rank() == 0


def _barrier(mesh) -> None:
    """Under a mesh, every rank waits here for rank 0's writes."""
    if mesh is not None:
        dist.barrier()


def render_frames(args, poses_mtx, local_tensorfs, logfolder, test_dataset, train_dataset):
    """Final render outputs (ref: train.py:63-140). Every rank renders; only
    rank 0 writes (the others render with no save path)."""
    writes = _rank0(local_tensorfs.mesh)
    if writes:
        save_transforms(poses_mtx, f"{logfolder}/transforms.json", local_tensorfs, train_dataset)
        t_w2rf = np.stack(local_tensorfs.world2rf, axis=0)
        rf_mtx_inv = np.concatenate(
            [np.tile(np.eye(3, dtype=np.float32), (len(t_w2rf), 1, 1)), t_w2rf[..., None]],
            axis=-1,
        )
        save_transforms(rf_mtx_inv, f"{logfolder}/transforms_rf.json", local_tensorfs)

    w, h = train_dataset.img_wh

    if args.render_test:
        render(
            test_dataset,
            poses_mtx,
            local_tensorfs,
            args,
            w=w,
            h=h,
            save_path=f"{logfolder}/test" if writes else None,
            save_frames=True,
            save_video=False,
            add_frame_to_list=False,
            test=True,
            train_dataset=train_dataset,
            img_format="png",
            start=0,
        )

    if args.render_path:
        c2ws = smooth_poses_spline(poses_mtx, median_prefilter=True)
        if writes:
            os.makedirs(f"{logfolder}/smooth_spline", exist_ok=True)
            save_transforms(c2ws, f"{logfolder}/smooth_spline/transforms.json", local_tensorfs)
        render(
            test_dataset,
            c2ws,
            local_tensorfs,
            args,
            w=int(w / 1.5),
            h=int(h / 1.5),
            save_path=f"{logfolder}/smooth_spline" if writes else None,
            train_dataset=train_dataset,
            img_format="jpg",
            save_frames=True,
            save_video=not args.skip_saving_video,
            add_frame_to_list=False,
            floater_thresh=0.5,
        )

    if args.render_from_file:
        with open(args.render_from_file) as f:
            transforms = json.load(f)
        c2ws = np.array(
            [t["transform_matrix"] for t in transforms["frames"]], np.float32
        )[..., :3, :]
        if args.with_preprocessed_poses:
            raw2ours = np.linalg.inv(
                np.asarray(train_dataset.first_pose, np.float32)
            )
            for c2w in c2ws:
                c2w[:3, :3] = raw2ours[:3, :3] @ c2w[:3, :3]
                c2w[:3, 3] = raw2ours[:3, :3] @ c2w[:3, 3] + raw2ours[:3, 3]
            c2ws[:, :3, 3] *= train_dataset.pose_scale
        save_path = f"{logfolder}/{os.path.splitext(os.path.basename(args.render_from_file))[0]}"
        if writes:
            os.makedirs(save_path, exist_ok=True)
        render(
            test_dataset,
            c2ws,
            local_tensorfs,
            args,
            w=w,
            h=h,
            save_path=save_path if writes else None,
            train_dataset=train_dataset,
            img_format="jpg",
            save_frames=True,
            save_video=not args.skip_saving_video,
            add_frame_to_list=False,
            floater_thresh=0.5,
        )
    _barrier(local_tensorfs.mesh)


def _warn_tb_failure(category: str, exc: Exception, warned: set) -> None:
    """TensorBoard image logging is best-effort (a broken cv2 stack must not
    kill training), but a failure is reported once per category (`warned`:
    the run's set of categories already reported)."""
    if category not in warned:
        warned.add(category)
        print(
            f"WARNING: TensorBoard '{category}' logging failed"
            f" ({type(exc).__name__}: {exc}) — suppressing further"
            f" warnings for this category"
        )


def _warn_inert_xla_flags(args) -> None:
    """The JAX package's XLA gather flags parse but change nothing here
    (config.INERT_FLAGS): say so when one is set."""
    for flag in ("fused_plane_gather", "fused_line_gather", "fused_fwd_gather"):
        if getattr(args, flag, 0):
            print(f"WARNING: --{flag}={getattr(args, flag)} has no effect: {INERT_FLAGS[flag]}")


def _camera_prior(args, train_dataset) -> dict | None:
    if not args.with_preprocessed_poses:
        return None
    return {"rel_poses": train_dataset.rel_poses, "transforms": train_dataset.transforms}


def _make_model(args, train_dataset) -> LocalTensorfs:
    _warn_inert_xla_flags(args)
    upsamp_list = args.upsamp_list
    n_voxel_raw = (
        np.round(
            np.exp(
                np.linspace(
                    np.log(args.N_voxel_init),
                    np.log(args.N_voxel_final),
                    len(upsamp_list) + 1,
                )
            )
        )
        .astype(np.int64)
        .tolist()[1:]
    )
    n_voxel_list = {
        u: round(v ** (1 / 3)) ** 3 for u, v in zip(upsamp_list, n_voxel_raw)
    }

    aabb = train_dataset.scene_bbox
    reso_cur = n_to_reso(args.N_voxel_init, aabb)

    tf_cfg = TensorfConfig(
        grid_size=tuple(reso_cur),
        density_n_comp=tuple(args.n_lamb_sigma),
        app_n_comp=tuple(args.n_lamb_sh),
        app_dim=args.data_dim_color,
        feature_c=args.featureC,
        density_shift=args.density_shift,
        distance_scale=args.distance_scale,
        ray_march_weight_thres=args.rm_weight_mask_thre,
        alpha_mask_thres=args.alpha_mask_thre,
        step_ratio=args.step_ratio,
        fea2dense_act=args.fea2denseAct,
        shading_mode=args.shadingMode,
        pos_pe=args.pos_pe,
        view_pe=args.view_pe,
        fea_pe=args.fea_pe,
        app_top_k=args.app_top_k,
        pallas_composite=bool(args.use_pallas),
        binned_scatter=bool(args.binned_scatter),
        binned_min_rows=int(args.binned_min_rows),
        line_bwd=args.line_bwd,
        gather_dtype=args.gather_dtype,
        mlp_dtype=args.mlp_dtype,
        fused_march=bool(args.fused_march),
        occ_probe_ds=args.occ_probe_ds,
        occ_refine=bool(args.occ_refine),
        n_samples_cap=int(args.nSamples),
        aabb_lo=tuple(float(v) for v in aabb[0]),
        aabb_hi=tuple(float(v) for v in aabb[1]),
    )
    cfg = LocalConfig(
        fov=args.fov,
        n_init_frames=min(args.n_init_frames, train_dataset.num_images),
        n_overlap=args.n_overlap,
        WH=tuple(train_dataset.img_wh),
        n_iters_per_frame=args.n_iters_per_frame,
        n_iters_reg=args.n_iters_reg,
        lr_R_init=args.lr_R_init,
        lr_t_init=args.lr_t_init,
        lr_i_init=args.lr_i_init,
        lr_exposure_init=args.lr_exposure_init,
        rf_lr_init=args.lr_init,
        rf_lr_basis=args.lr_basis,
        lr_decay_target_ratio=args.lr_decay_target_ratio,
        N_voxel_list=n_voxel_list,
        update_AlphaMask_list=args.update_AlphaMask_list,
        lr_upsample_reset=bool(args.lr_upsample_reset),
        loss_flow_weight=args.loss_flow_weight_inital,
        loss_depth_weight=args.loss_depth_weight_inital,
        tv_weight_density=args.TV_weight_density,
        tv_weight_app=args.TV_weight_app,
        l1_weight=args.L1_weight,
        n_views=args.n_views,
        batch_size=args.batch_size,
        occ_ratio=args.occ_ratio,
        occ_min=args.occ_min,
        moment_dtype=args.moment_dtype,
        seed=args.seed,
        tensorf=tf_cfg,
    )
    return LocalTensorfs(cfg, _camera_prior(args, train_dataset), device=args.device)


def _launch_command(n: int) -> str:
    return ("python -m torch.distributed.run --nproc_per_node"
            f" {n} -m localrf_tpu_torch.train {shlex.join(sys.argv[1:])}")


def _data_parallel(args):
    """Ray-batch data parallelism over the ranks of this launch (JAX: over
    the devices of one process). --data_parallel 0 is the world size
    (torch.distributed.run's WORLD_SIZE; 1 for a plain launch); any other
    value must equal it, so a run never trains quietly on fewer cards than
    asked. Above one rank, initializes the process group (NCCL on
    cuda:LOCAL_RANK for a cuda --device, which it sets in args; gloo for
    cpu) and returns the "data" mesh over every rank; else None."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dp = args.data_parallel or world
    if dp != world:
        raise ValueError(
            f"--data_parallel {args.data_parallel} asks for {dp} ranks and this launch has {world};"
            f" launch one rank a card: {_launch_command(dp)}")
    cuda = torch.device(args.device).type == "cuda"
    visible = torch.cuda.device_count() if cuda else 0
    if visible > world and int(os.environ.get("RANK", "0")) == 0:
        print(f"data parallel: {world} of the {visible} visible cards; all of them: {_launch_command(visible)}")
    if world == 1:
        return None
    if cuda:
        local_rank = int(os.environ["LOCAL_RANK"])
        torch.cuda.set_device(local_rank)
        args.device = f"cuda:{local_rank}"
    if not dist.is_initialized():
        dist.init_process_group("nccl" if cuda else "gloo")
    return make_mesh(world, "cuda" if cuda else "cpu")


def reconstruction(args, train_dataset=None, test_dataset=None):
    mesh = _data_parallel(args)
    # speedup-factor rescaling (ref: train.py:207-220)
    args.n_iters_per_frame = int(args.n_iters_per_frame / args.refinement_speedup_factor)
    args.n_iters_reg = int(args.n_iters_reg / args.refinement_speedup_factor)
    args.upsamp_list = [int(u / args.refinement_speedup_factor) for u in args.upsamp_list]
    args.update_AlphaMask_list = [
        int(u / args.refinement_speedup_factor) for u in args.update_AlphaMask_list
    ]
    args.add_frames_every = int(args.add_frames_every / args.prog_speedup_factor)
    args.lr_R_init = args.lr_R_init * args.prog_speedup_factor
    args.lr_t_init = args.lr_t_init * args.prog_speedup_factor
    args.loss_flow_weight_inital = args.loss_flow_weight_inital * args.prog_speedup_factor
    args.L1_weight = args.L1_weight * args.prog_speedup_factor
    args.TV_weight_density = args.TV_weight_density * args.prog_speedup_factor
    args.TV_weight_app = args.TV_weight_app * args.prog_speedup_factor

    if train_dataset is None:
        train_dataset = LocalRFDataset(
            args.datadir,
            split="train",
            downsampling=args.downsampling,
            test_frame_every=args.test_frame_every,
            load_depth=args.loss_depth_weight_inital > 0,
            load_flow=args.loss_flow_weight_inital > 0,
            with_preprocessed_poses=bool(args.with_preprocessed_poses),
            n_init_frames=args.n_init_frames,
            subsequence=args.subsequence,
            frame_step=args.frame_step,
        )
        test_dataset = LocalRFDataset(
            args.datadir,
            split="test",
            load_depth=args.loss_depth_weight_inital > 0,
            load_flow=args.loss_flow_weight_inital > 0,
            downsampling=args.downsampling,
            test_frame_every=args.test_frame_every,
            with_preprocessed_poses=bool(args.with_preprocessed_poses),
            subsequence=args.subsequence,
            frame_step=args.frame_step,
        )

    logfolder = args.logdir
    rank0 = _rank0(mesh)
    if rank0:
        os.makedirs(logfolder, exist_ok=True)
    writer = _make_writer(logfolder) if rank0 else None
    tb_warned: set = set()

    w, h = train_dataset.img_wh

    optimize_poses = args.lr_R_init > 0 or args.lr_t_init > 0
    training = True
    n_added_frames = 0
    last_add_iter = 0
    iteration = 0
    metrics = {}

    model = None
    if args.resume:
        for cand in (
            f"{logfolder}/checkpoints_tmp.th",
            f"{logfolder}/checkpoints.th",
        ):
            if os.path.isfile(cand):
                model, extra = load_checkpoint(
                    cand, camera_prior=_camera_prior(args, train_dataset), return_extra=True,
                    device=args.device,
                )
                iteration = int(extra.get("iteration", 0))
                n_added_frames = int(extra.get("n_added_frames", 0))
                last_add_iter = int(extra.get("last_add_iter", 0))
                b0, b1 = extra.get("active_bounds", (0, model.n_frames))
                train_dataset.activate_frames(
                    b1 - train_dataset.active_frames_bounds[1]
                )
                if b0 > 0:
                    train_dataset.deactivate_frames(b0)
                print(f"Resumed from {cand} at iteration {iteration}")
                break
    if model is None:
        model = _make_model(args, train_dataset)
    if mesh is not None:
        model.set_mesh(mesh)
        if rank0:
            print(f"ray-batch data parallelism over {mesh.size()} ranks")

    if args.pixel_pool and args.scan_chunk > 1:
        capacity = args.n_max_frames + args.n_overlap + 16
        model.attach_pool(DevicePixelPool(train_dataset, capacity, device=args.device))
        if rank0:
            print(f"device pixel pool: {capacity} frame slots")

    start_time = time.time()

    scan_chunk = max(1, args.scan_chunk)

    def _max_chunk_len() -> int:
        """Largest chunk that keeps progressive/vis events on its last step."""
        length = scan_chunk
        if not model.is_refining:
            if iteration - last_add_iter >= args.add_frames_every:
                return 1  # refine-flip zone: per-iteration drift checks
            f = (iteration - last_add_iter + 1) % args.add_frames_every
            steps_until = (args.add_frames_every - f) % args.add_frames_every
            length = min(length, steps_until + 1)
        steps_to_vis = args.vis_every - 1 - (iteration % args.vis_every)
        return max(1, min(length, steps_to_vis + 1))

    while training:
        if scan_chunk > 1:
            batches = model.plan_chunk(train_dataset, optimize_poses, _max_chunk_len())
            can_add_rf = model.run_chunk(batches, optimize_poses)
            if any(not b["train_test_poses"] for b in batches):
                training |= (
                    train_dataset.active_frames_bounds[1] != train_dataset.num_images
                )
            iteration += len(batches) - 1  # post-block sees the last executed step
        else:
            batch = train_dataset.sample(
                args.batch_size, model.is_refining, optimize_poses, n_views=args.n_views
            )
            train_test_poses = batch["train_test_poses"]

            if train_test_poses:
                can_add_rf = False
                if optimize_poses:
                    model.optimizer_step_poses_only(batch)
            else:
                can_add_rf = model.optimizer_step(batch, optimize_poses)
                training |= (
                    train_dataset.active_frames_bounds[1] != train_dataset.num_images
                )

        # progressive state machine (ref: train.py:440-474)
        if not model.is_refining:
            should_refine = not train_dataset.has_left_frames() or (
                n_added_frames > args.n_overlap
                and (
                    model.get_dist_to_last_rf() > args.max_drift
                    or (
                        train_dataset.active_frames_bounds[1]
                        - train_dataset.active_frames_bounds[0]
                    )
                    >= args.n_max_frames
                )
            )
            if should_refine and (iteration - last_add_iter) >= args.add_frames_every:
                model.is_refining = True

            should_add_frame = train_dataset.has_left_frames()
            should_add_frame &= (iteration - last_add_iter + 1) % args.add_frames_every == 0
            should_add_frame &= not should_refine
            should_add_frame &= not model.is_refining
            if should_add_frame:
                model.append_frame()
                train_dataset.activate_frames()
                # overlap the next chunk's decode with training
                if hasattr(train_dataset, "prefetch_next_chunk"):
                    train_dataset.prefetch_next_chunk()
                n_added_frames += 1
                last_add_iter = iteration

        if can_add_rf:
            if train_dataset.has_left_frames():
                model.append_rf(n_added_frames)
                n_added_frames = 0
                training_frames = model.blending_weights[:, -1] > 0
                first = int(np.argmax(training_frames))
                train_dataset.deactivate_frames(first)
                model.set_window_start(first)
            else:
                training = False

        # logging (scalar set mirrors ref: train.py:475-527)
        if writer is not None:
            # host-resident scalars: every loop iteration (free)
            for k, v in model.last_metrics.items():
                writer.add_scalar(f"train/{k}", v, global_step=iteration)
            writer.add_scalar(
                "active_frames_bounds/0", train_dataset.active_frames_bounds[0], iteration
            )
            writer.add_scalar(
                "active_frames_bounds/1", train_dataset.active_frames_bounds[1], iteration
            )
            # scalars read from the device (opt lr_scale, pose lrs,
            # focal/center): at progress_refresh_rate only, since a read
            # waits for the card; the curves are smooth schedules
            if iteration % args.progress_refresh_rate < (
                1 if scan_chunk <= 1 else scan_chunk
            ):
                f_last = model.fields[-1]
                lr_scale = float(f_last["opt"].lr_scale)
                writer.add_scalar(
                    "train/density_app_plane_lr", model.cfg.rf_lr_init * lr_scale, iteration
                )
                writer.add_scalar(
                    "train/basis_mat_lr", model.cfg.rf_lr_basis * lr_scale, iteration
                )
                lr_r = model._pose_dev.r_opt.lr.cpu().numpy()
                lr_t = model._pose_dev.t_opt.lr.cpu().numpy()
                last = model.win_len - 1
                writer.add_scalar("train/lr_r", float(lr_r[last]), iteration)
                writer.add_scalar("train/lr_t", float(lr_t[last]), iteration)
                writer.add_scalar("train/focal", model.focal(w), iteration)
                center = model.center(w, h)
                writer.add_scalar("train/center0", float(center[0]), iteration)
                writer.add_scalar("train/center1", float(center[1]), iteration)
                # per-RF frame coverage bounds (ref: train.py:517-527)
                for rf_i in range(model.blending_weights.shape[1]):
                    active = np.nonzero(model.blending_weights[:, rf_i])[0]
                    if len(active):
                        writer.add_scalar(f"tensorf_bounds/rf{rf_i}_b0", int(active[0]), iteration)
                        writer.add_scalar(f"tensorf_bounds/rf{rf_i}_b1", int(active[-1]), iteration)

        if rank0 and iteration % args.progress_refresh_rate < (
            1 if scan_chunk <= 1 else scan_chunk
        ):
            ips = min(args.progress_refresh_rate, iteration + 1) / (
                time.time() - start_time
            )
            if writer is not None:
                writer.add_scalar("train/iter_per_sec", ips, global_step=iteration)
                writer.add_scalar(
                    "train/rays_per_sec", ips * args.batch_size, global_step=iteration
                )
                # pose + field-origin wireframe (ref: train.py:529-538)
                try:
                    poses_mtx = model.get_cam2world()
                    t_w2rf = np.stack(model.world2rf, axis=0)
                    rf_inv = np.concatenate(
                        [
                            np.tile(np.eye(3, dtype=np.float32), (len(t_w2rf), 1, 1)),
                            -t_w2rf[..., None],
                        ],
                        axis=-1,
                    )
                    all_poses = np.concatenate([poses_mtx, rf_inv], axis=0)
                    colours = ["C1"] * len(poses_mtx) + ["C2"] * len(rf_inv)
                    img = draw_poses(all_poses, colours)
                    writer.add_image(
                        "poses/all",
                        (np.transpose(img, (2, 0, 1)) / 255.0).astype(np.float32),
                        iteration,
                    )
                except Exception as exc:
                    _warn_tb_failure("poses/all", exc, tb_warned)
            print(
                f"Iteration {iteration:06d}: {ips:.2f} it/s"
                f" ({ips * args.batch_size:,.0f} rays/s)"
                f" rgb_loss={model.last_metrics.get('rgb_loss', float('nan')):.4f}"
            )
            start_time = time.time()

        if iteration % args.vis_every == args.vis_every - 1:
            poses_mtx = model.get_cam2world()
            rgb_tb, depth_tb, gt_tb, fwd_cmp_tb, bwd_cmp_tb, depth_cmp_tb, loc_metrics = render(
                test_dataset,
                poses_mtx,
                model,
                args,
                w=w // 2,
                h=h // 2,
                save_path=logfolder if rank0 else None,
                save_frames=True,
                img_format="jpg",
                test=True,
                train_dataset=train_dataset,
                start=train_dataset.active_frames_bounds[0],
                add_frame_to_list=not args.skip_TB_images,
            )
            if loc_metrics:
                metrics.update(loc_metrics)
                mses = [m["mse"] for m in metrics.values()]
                psnr = -10.0 * np.log(np.mean(mses)) / np.log(10.0)
                ssims = [m["ssim"] for m in metrics.values()]
                if writer is not None:
                    writer.add_scalar("test/PSNR", psnr, global_step=iteration)
                    writer.add_scalar("test/ssim", float(np.mean(ssims)), iteration)
                if rank0:
                    print(f"test PSNR={psnr:.2f} SSIM={np.mean(ssims):.3f}")
            if writer is not None and not args.skip_TB_images:
                # test render / gt / error-panel images (ref: train.py:586-631)
                def _add_images(tag, frames, gray=False):
                    if not frames:
                        return
                    arr = np.stack(frames, 0).astype(np.float32)
                    if gray:
                        arr = arr[..., None]
                    writer.add_images(tag, arr, global_step=iteration, dataformats="NHWC")

                try:
                    _add_images("test/rgb_maps", rgb_tb)
                    _add_images("test/depth_map", depth_tb)
                    _add_images("test/gt_maps", gt_tb)
                    _add_images("test/fwd_flow_cmp", fwd_cmp_tb, gray=True)
                    _add_images("test/bwd_flow_cmp", bwd_cmp_tb, gray=True)
                    _add_images("test/depth_cmp", depth_cmp_tb, gray=True)
                except Exception as exc:
                    _warn_tb_failure("test image panels", exc, tb_warned)
            if rank0:
                save_checkpoint(
                    model,
                    f"{logfolder}/checkpoints_tmp.th",
                    extra={
                        "iteration": iteration,
                        "n_added_frames": n_added_frames,
                        "last_add_iter": last_add_iter,
                        "active_bounds": tuple(train_dataset.active_frames_bounds),
                    },
                )
            _barrier(mesh)

        iteration += 1

    if rank0:
        save_checkpoint(model, f"{logfolder}/checkpoints.th")
    _barrier(mesh)
    poses_mtx = model.get_cam2world()
    render_frames(
        args, poses_mtx, model, logfolder,
        test_dataset=test_dataset, train_dataset=train_dataset,
    )
    return model, metrics


def render_test(args):
    """Render-only entry restoring from a checkpoint (ref: train.py:142-203);
    every rank loads it, eval frames split over the ranks."""
    mesh = _data_parallel(args)
    train_dataset = LocalRFDataset(
        args.datadir,
        split="train",
        downsampling=args.downsampling,
        test_frame_every=args.test_frame_every,
        n_init_frames=args.n_init_frames,
        with_preprocessed_poses=bool(args.with_preprocessed_poses),
        subsequence=args.subsequence,
        frame_step=args.frame_step,
    )
    test_dataset = LocalRFDataset(
        args.datadir,
        split="test",
        load_depth=args.loss_depth_weight_inital > 0,
        load_flow=args.loss_flow_weight_inital > 0,
        downsampling=args.downsampling,
        test_frame_every=args.test_frame_every,
        with_preprocessed_poses=bool(args.with_preprocessed_poses),
        subsequence=args.subsequence,
        frame_step=args.frame_step,
    )

    logfolder = args.logdir
    ckpt_path = args.ckpt if args.ckpt else f"{logfolder}/checkpoints.th"
    if not os.path.isfile(ckpt_path):
        print("Backing up to intermediate checkpoints")
        ckpt_path = f"{logfolder}/checkpoints_tmp.th"
        if not os.path.isfile(ckpt_path):
            print("the ckpt path does not exists!!")
            return

    model = load_checkpoint(ckpt_path, camera_prior=_camera_prior(args, train_dataset), device=args.device)
    if mesh is not None:
        model.set_mesh(mesh)
    logfolder = os.path.dirname(ckpt_path)
    render_frames(
        args,
        model.get_cam2world(),
        model,
        logfolder,
        test_dataset=test_dataset,
        train_dataset=train_dataset,
    )


def _make_writer(logfolder):
    """A TensorBoard writer into the log folder; None without tensorboard."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir=logfolder)


def main():
    args = config_parser()
    if int(os.environ.get("RANK", "0")) == 0:
        print(args)
    np.random.seed(args.seed)
    try:
        if args.render_only:
            render_test(args)
        else:
            reconstruction(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

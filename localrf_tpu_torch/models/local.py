"""LocalTensorfs: host-side progressive manager over the training step
(PyTorch port of localrf_tpu/models/local.py).

Trainable state lives on `device`: a sliding pose window and the active
field. The host keeps the full per-frame history, the schedule (lr decay,
refine/regularize flags, gates, upsampling, occupancy refresh) and the
retired fields, whose parameters move to host memory when the next field
spawns.

Ported: construction, frame append, spawning fields with the cross-fade
ladder (`append_rf`), sliding the pose window (`set_window_start`),
`optimizer_step` / `optimizer_step_poses_only` (one eager step), the chunk
path `plan_chunk` -> `run_chunk` (the default `--scan_chunk 16
--pixel_pool 1` of the JAX package), whose steps replay captured CUDA
graphs on a card (models/graph.py) and loop on the CPU, the queries the
training loop reads, the blended eval render `forward_eval`, and ray-batch
data parallelism over torch.distributed ranks (`set_mesh`,
parallel/sharding.py).

Under a mesh every rank runs every step, event and eval, and so every
collective, in the same order: the host schedule (which reads the pose
window, e.g. get_dist_to_last_rf) is the same on every rank only while the
replicas are equal bit for bit, which the reduced gradients keep them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..ops.math import mtx_to_sixD, n_to_reso, sixD_to_mtx
from ..optim import AdamState, pytree_adam_init
from ..parallel.sharding import (
    _SHARDED_KEYS,
    POOL_SHARDED_KEYS,
    all_sum_,
    captures_collectives,
    data_rank,
    replicate_tree,
    shard_batch,
)
from ..utils import profiling
from .graph import ChunkGraphs
from .render import draw_noise
from .step import (
    FieldState,
    IntrState,
    PoseState,
    StepBranches,
    StepStatics,
    _apply_exposure,
    cam2world_from_params,
    render_chunk,
    render_frame,
    row,
    stack_noise,
    stack_scalars,
    train_chunk,
    train_chunk_pooled,
    train_step,
    train_step_poses_only,
)
from .tensorf import (
    TensorfConfig,
    TensorfField,
    build_combined_quad_views,
    init_tensorf,
    update_alpha_volume,
    upsample_tensorf,
)


@dataclasses.dataclass
class LocalConfig:
    """Configuration of the progressive multi-field model (the JAX
    LocalConfig's fields)."""

    fov: float = 85.6
    n_init_frames: int = 5
    n_overlap: int = 30
    WH: tuple[int, int] = (960, 540)
    n_iters_per_frame: int = 600
    n_iters_reg: int = 100
    lr_R_init: float = 5e-3
    lr_t_init: float = 5e-4
    lr_i_init: float = 0.0
    lr_exposure_init: float = 1e-3
    rf_lr_init: float = 0.02
    rf_lr_basis: float = 1e-3
    lr_decay_target_ratio: float = 0.1
    N_voxel_list: dict[int, int] = dataclasses.field(default_factory=dict)
    update_AlphaMask_list: list[int] = dataclasses.field(default_factory=list)
    lr_upsample_reset: bool = True
    loss_flow_weight: float = 1.0
    loss_depth_weight: float = 0.1
    tv_weight_density: float = 0.0
    tv_weight_app: float = 0.0
    l1_weight: float = 1e-2
    n_views: int = 16
    batch_size: int = 4096
    occ_ratio: float = 0.45
    occ_min: int = 256
    moment_dtype: str = "float32"
    tensorf: TensorfConfig = dataclasses.field(
        default_factory=lambda: TensorfConfig(grid_size=(64, 64, 64))
    )
    seed: int = 20211202

    @property
    def px_per_view(self) -> int:
        return self.batch_size // self.n_views


def _rot6d_roundtrip(r: np.ndarray) -> np.ndarray:
    """mtx_to_sixD(sixD_to_mtx(r)) on host float32."""
    return mtx_to_sixD(sixD_to_mtx(torch.from_numpy(np.ascontiguousarray(r)))).numpy()


class LocalTensorfs:
    # ray-batch data parallelism (set_mesh): the "data" mesh, and whether the
    # replicated state is known equal on every rank since it was last rebuilt
    mesh = None
    _replicated = True

    def __init__(self, cfg: LocalConfig, camera_prior: dict | None = None, device="cuda"):
        self.cfg = cfg
        self.camera_prior = camera_prior
        self.device = torch.device(device)
        self.W, self.H = cfg.WH
        # field init and every step's noise come from this generator
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)

        # --- per-frame host state (full history) ---
        self.r_all = np.zeros((0, 3, 2), np.float32)
        self.t_all = np.zeros((0, 3), np.float32)
        self.exp_all = np.zeros((0, 3, 3), np.float32)
        self.pose_opt_all: dict[str, np.ndarray] = {}
        self.pose_linked_rf: list[int] = []
        self.blending_weights = np.ones((0, 1), np.float32)

        # --- per-field state ---
        self.fields: list[dict[str, Any]] = []
        self.world2rf: list[np.ndarray] = []
        self.rf_iter: list[int] = []

        # --- schedule state ---
        self.is_refining = False
        self.lr_factor = 1.0
        self.n_iters = cfg.n_iters_per_frame
        self.n_iters_reg = cfg.n_iters_reg
        self.N_voxel_list = dict(cfg.N_voxel_list)
        self.update_AlphaMask_list = list(cfg.update_AlphaMask_list)

        # --- intrinsics ---
        if camera_prior is not None:
            focal = camera_prior["transforms"]["fl_x"]
            focal *= self.W / camera_prior["transforms"]["w"]
        else:
            focal = self.W / math.tan(cfg.fov * math.pi / 180 / 2) / 2
        self.init_focal = float(focal)
        intr_params = {
            "focal_offset": torch.ones((), device=self.device),
            "center_rel": 0.5 * torch.ones((2,), device=self.device),
        }
        self.intr = IntrState(intr_params, pytree_adam_init(intr_params))

        # --- device pose window ---
        self.win_start = 0
        self._wc = 64  # capacity; grows in steps of 32
        self._pose_dev: PoseState | None = None

        # --- optional device-resident pixel pool (attach_pool) ---
        self.pool = None
        # --- the chunk path's captured step graphs (CUDA only) ---
        self._graphs = ChunkGraphs(self.device) if self.device.type == "cuda" else None

        for _ in range(cfg.n_init_frames):
            self.append_frame()
        self.append_rf()

    # ------------------------------------------------------------------
    # window plumbing
    # ------------------------------------------------------------------

    @property
    def n_frames(self) -> int:
        return self.r_all.shape[0]

    @property
    def win_len(self) -> int:
        return self.n_frames - self.win_start

    def _next_noise(self, tf_cfg: TensorfConfig) -> dict:
        return draw_noise(tf_cfg.n_samples, self._gen, self.device)

    def _init_pose_opt_rows(self, n: int) -> dict[str, np.ndarray]:
        c = self.cfg
        rows = {}
        for name, shape, lr in (
            ("r", (3, 2), c.lr_R_init), ("t", (3,), c.lr_t_init), ("e", (3, 3), c.lr_exposure_init)
        ):
            rows[f"{name}_m"] = np.zeros((n, *shape), np.float32)
            rows[f"{name}_v"] = np.zeros((n, *shape), np.float32)
            rows[f"{name}_step"] = np.zeros((n,), np.int32)
            rows[f"{name}_lr"] = np.full((n,), lr, np.float32)
        return rows

    def sync_window_to_host(self):
        """Pull the device pose window back into the full host arrays."""
        if self._pose_dev is None:
            return
        s, l = self.win_start, self.win_len
        p = self._pose_dev

        def host(x):
            return x[:l].detach().cpu().numpy()

        self.r_all[s : s + l] = host(p.r)
        self.t_all[s : s + l] = host(p.t)
        self.exp_all[s : s + l] = host(p.exposure)
        o = self.pose_opt_all
        for name, st in (("r", p.r_opt), ("t", p.t_opt), ("e", p.e_opt)):
            o[f"{name}_m"][s : s + l] = host(st.m)
            o[f"{name}_v"][s : s + l] = host(st.v)
            o[f"{name}_step"][s : s + l] = host(st.step)
            o[f"{name}_lr"][s : s + l] = host(st.lr)

    def drop_graphs(self):
        """Release the chunk path's captured graphs (a schedule event: they
        are captured again at the next chunk)."""
        if self._graphs is not None:
            self._graphs.drop()

    def _build_window(self):
        """(Re)build the device pose window [win_start, n_frames) padded to
        capacity."""
        self.drop_graphs()
        self._replicated = False
        s, l = self.win_start, self.win_len
        while l > self._wc:
            self._wc += 32
        wc = self._wc

        def dev(a: np.ndarray) -> torch.Tensor:
            out = np.zeros((wc,) + a.shape[1:], a.dtype)
            out[:l] = a[s : s + l]
            if a.ndim == 3 and a.shape[1:] == (3, 3):
                out[l:] = np.eye(3, dtype=a.dtype)  # keep padding exposures sane
            return torch.from_numpy(out).to(self.device)

        o = self.pose_opt_all

        def adam(name) -> AdamState:
            return AdamState(*(dev(o[f"{name}_{k}"]) for k in ("m", "v", "step", "lr")))

        self._pose_dev = PoseState(
            r=dev(self.r_all), t=dev(self.t_all), exposure=dev(self.exp_all),
            r_opt=adam("r"), t_opt=adam("t"), e_opt=adam("e"),
        )

    def set_window_start(self, start: int):
        """Slide the window after frames are deactivated. The window keeps one
        frame before the first active frame for bwd-flow supervision."""
        start = max(start - 1, 0)
        if start != self.win_start:
            self.sync_window_to_host()
            self.win_start = start
            self._build_window()

    def _gate(self) -> np.ndarray:
        """Per-window-frame bool: pose/exposure updates only for frames linked
        to the current field while it still trains."""
        cur = len(self.rf_iter) - 1
        gate = np.zeros((self._wc,), bool)
        if self.rf_iter[-1] < self.n_iters:
            for i in range(self.win_len):
                if self.pose_linked_rf[self.win_start + i] == cur:
                    gate[i] = True
        return gate

    # ------------------------------------------------------------------
    # progressive growth
    # ------------------------------------------------------------------

    def append_frame(self):
        self.sync_window_to_host()
        if self.n_frames == 0:
            r = np.eye(3, dtype=np.float32)[:, :2][None]
            t = np.zeros((1, 3), np.float32)
            self.pose_linked_rf.append(0)
            self.blending_weights = np.ones((1, 1), np.float32)
        else:
            r = _rot6d_roundtrip(self.r_all[-1:])
            t = self.t_all[-1:].copy()
            self.blending_weights = np.concatenate(
                [self.blending_weights, self.blending_weights[-1:, :]], axis=0
            )
            # threshold, not exact nonzero: the cross-fade ladder can leave a
            # ~1e-16 residue in a retired column, which would link the frame
            # to the retired field and freeze its pose (JAX local.py:282-291)
            w_row = self.blending_weights[-1, :]
            self.pose_linked_rf.append(int(np.nonzero(w_row > 1e-6)[0][0]))

        exp = np.eye(3, dtype=np.float32)[None]
        if self.camera_prior is not None:
            rel_pose = np.asarray(self.camera_prior["rel_poses"][self.n_frames], np.float32)
            last_r = sixD_to_mtx(torch.from_numpy(np.ascontiguousarray(r))).numpy()[0]
            r = mtx_to_sixD(torch.from_numpy((last_r @ rel_pose[:3, :3])[None])).numpy()
            t = t + (last_r @ rel_pose[:3, 3])[None]

        self.r_all = np.concatenate([self.r_all, r], axis=0)
        self.t_all = np.concatenate([self.t_all, t], axis=0)
        self.exp_all = np.concatenate([self.exp_all, exp], axis=0)
        rows = self._init_pose_opt_rows(1)
        if not self.pose_opt_all:
            self.pose_opt_all = rows
        else:
            for k in rows:
                self.pose_opt_all[k] = np.concatenate([self.pose_opt_all[k], rows[k]], axis=0)
        self._build_window()

    def append_rf(self, n_added_frames: int = 1):
        """Spawn a field. Past the first, the last n_overlap frames cross-fade
        from the previous field to the new one, the new field is centred on
        the last frame's position, and the previous field retires: its
        parameters move to host memory and its optimizer state is dropped."""
        self.sync_window_to_host()
        self.is_refining = False
        if self.fields:
            n_overlap = min(n_added_frames, self.cfg.n_overlap, self.blending_weights.shape[0] - 1)
            # k/n directly, in float64: the last weight is then exactly 1.0
            # and the retired column's "1 - w" exactly 0.0 for every
            # n_overlap (JAX local.py:325-329)
            weights_overlap = np.arange(1, n_overlap + 1, dtype=np.float64) / n_overlap
            self.blending_weights[-n_overlap:, -1] = 1 - weights_overlap
            new_col = np.zeros_like(self.blending_weights[:, 0:1])
            new_col[-n_overlap:, 0] = weights_overlap
            self.blending_weights = np.concatenate([self.blending_weights, new_col], axis=1)
            world2rf = -self.t_all[-1].copy()
            # a captured graph keeps every tensor it read alive in its pool:
            # drop them before the retired field leaves the card
            self.drop_graphs()
            prev = self.fields[-1]
            prev["params"] = TensorfField(
                {k: p.detach().cpu() for k, p in prev["params"].named_parameters()})
            prev["opt"] = None
        else:
            world2rf = np.zeros(3, np.float32)
        tf_cfg = self.cfg.tensorf
        self._replicated = False
        params = init_tensorf(tf_cfg, self._gen, self.device)
        self.fields.append({
            "params": params,
            "cfg": tf_cfg,
            "alpha_volume": None,
            "opt": pytree_adam_init(params, self.cfg.moment_dtype),
        })
        self.world2rf.append(np.asarray(world2rf, np.float32))
        self.rf_iter.append(0)

    # ------------------------------------------------------------------
    # optimization
    # ------------------------------------------------------------------

    def _statics(self, optimize_poses: bool, n_views: int | None = None) -> StepStatics:
        """The step's statics; `n_views` is the views of this rank's share
        of the batch (default cfg.n_views)."""
        c = self.cfg
        f = self.fields[-1]
        return StepStatics(
            cfg=f["cfg"],
            w=self.W,
            h=self.H,
            n_views=c.n_views if n_views is None else n_views,
            px_per_view=c.px_per_view,
            wc=self._wc,
            fov360=(c.fov == 360),
            white_bg=True,
            optimize_poses=optimize_poses,
            exposure_on=c.lr_exposure_init > 0,
            intrinsics_on=c.lr_i_init > 0,
            flow_on=c.loss_flow_weight > 0 and c.fov != 360,
            depth_on=c.loss_depth_weight > 0 and c.fov != 360,
            has_alpha=f["alpha_volume"] is not None,
            flow_weight=c.loss_flow_weight,
            depth_weight=c.loss_depth_weight,
            lr_spatial=c.rf_lr_init,
            lr_net=c.rf_lr_basis,
        )

    def _scalars_py(self, pose_only: bool = False) -> dict[str, Any]:
        c = self.cfg
        it = self.rf_iter[-1]
        regularize = it < self.n_iters_reg
        reg_w = self.lr_factor**it
        reg_on = regularize and it < self.n_iters
        return {
            "init_focal": float(np.float32(self.init_focal)),
            "w_scale": 1.0,
            "world2rf": np.asarray(self.world2rf[-1], np.float32),
            "n_valid": int(self.win_len),
            "lr_factor": float(self.lr_factor),
            "reg_w": float(np.float32(reg_w)),
            "reg_flag": 1.0 if regularize else 0.0,
            "refine": 1.0 if self.is_refining else 0.0,
            "is_refining": 1.0 if self.is_refining else 0.0,
            "is_first_rf": 1.0 if self.blending_weights.shape[1] == 1 else 0.0,
            "tv_wd": float(np.float32(c.tv_weight_density * reg_w if reg_on else 0.0)),
            "tv_wa": float(np.float32(c.tv_weight_app * reg_w if reg_on else 0.0)),
            "l1_w": float(np.float32(c.l1_weight if reg_on else 0.0)),
            "lr_i_base": float(np.float32(c.lr_i_init)),
            "pose_only": 1.0 if pose_only else 0.0,
        }

    def _host_batch(self, batch: dict) -> dict:
        """Host batch -> numpy arrays with window-relative view ids."""
        view_rel = np.asarray(batch["view_ids"], np.int64) - self.win_start
        out = {
            "ray_idx": np.asarray(batch["idx"], np.int64),
            "view_ids": view_rel,
            "rgbs": np.asarray(batch["rgbs"], np.float32),
            "loss_weights": np.asarray(batch["loss_weights"], np.float32).reshape(-1, 1),
        }
        for k in ("fwd_flow", "bwd_flow"):
            if batch.get(k) is not None:
                out[k] = np.asarray(batch[k], np.float32)
        for k in ("fwd_mask", "bwd_mask", "invdepths"):
            if batch.get(k) is not None:
                out[k] = np.asarray(batch[k], np.float32).reshape(-1)
        return out

    def _scalar_row(self, scal: dict) -> dict:
        """One step's host scalars as device tensors (three copies)."""
        return row(stack_scalars([scal], self.device), 0)

    def _shard(self, batch: dict, keys, axis: int) -> dict:
        """This rank's share of a host batch (sharding.shard_batch)."""
        return batch if self.mesh is None else shard_batch(batch, self.mesh, keys, axis)

    def _device_batch(self, batch: dict) -> dict:
        """One step's batch on the device (this rank's share under a mesh)."""
        out = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for k, v in self._shard(self._host_batch(batch), _SHARDED_KEYS, 0).items()
        }
        out["gate"] = torch.from_numpy(self._gate()).to(self.device)
        return out

    def _schedule_entry(self):
        """Per-step schedule bookkeeping at step entry."""
        c = self.cfg
        if self.rf_iter[-1] == 0:
            self.lr_factor = 1.0
            self.n_iters = c.n_iters_per_frame
            self.n_iters_reg = c.n_iters_reg
        elif self.rf_iter[-1] == 1:
            n_training_frames = int((self.blending_weights[:, -1] > 0).sum())
            self.n_iters = int(c.n_iters_per_frame * n_training_frames)
            self.n_iters_reg = int(c.n_iters_reg * n_training_frames)
            self.lr_factor = c.lr_decay_target_ratio ** (1 / self.n_iters)
            self.N_voxel_list = {
                int(k * n_training_frames): v for k, v in c.N_voxel_list.items()
            }
            self.update_AlphaMask_list = [
                int(u * n_training_frames) for u in c.update_AlphaMask_list
            ]

    def _occ_m(self, tf_cfg: TensorfConfig, has_alpha: bool) -> int:
        """Compacted samples per ray once an alpha volume exists: ~45% of the
        march (floor 256); 0 (dense cull) when that keeps more than 85%."""
        if not has_alpha:
            return 0
        s = tf_cfg.n_samples // 6 * 2
        m = min(s, max(self.cfg.occ_min, int(s * self.cfg.occ_ratio)))
        return 0 if m > 0.85 * s else int(m)

    def _has_post_step_event(self, rf_iter: int) -> bool:
        return rf_iter in self.N_voxel_list or rf_iter in self.update_AlphaMask_list

    def _apply_post_step_events(self):
        """Upsample / occupancy refresh keyed on the pre-increment rf_iter;
        either one drops the captured graphs (new tensors)."""
        c = self.cfg
        f = self.fields[-1]
        if self._has_post_step_event(self.rf_iter[-1]):
            self.drop_graphs()
            self._replicated = False
        if self.rf_iter[-1] in self.N_voxel_list:
            reso = n_to_reso(self.N_voxel_list[self.rf_iter[-1]], f["cfg"].aabb)
            lr_scale = f["opt"].lr_scale
            f["params"], f["cfg"] = upsample_tensorf(f["params"], f["cfg"], reso)
            f["opt"] = pytree_adam_init(f["params"], c.moment_dtype)
            if not c.lr_upsample_reset:
                f["opt"] = f["opt"]._replace(lr_scale=lr_scale)
        if self.rf_iter[-1] in self.update_AlphaMask_list:
            reso_mask = tuple(int(g / 2) for g in f["cfg"].grid_size)
            f["alpha_volume"] = update_alpha_volume(f["params"], f["cfg"], reso_mask)
        f["cfg"] = dataclasses.replace(
            f["cfg"], occ_m=self._occ_m(f["cfg"], f["alpha_volume"] is not None)
        )

    def optimizer_step(self, batch: dict, optimize_poses: bool) -> bool:
        """One eager joint step; returns can_add_rf."""
        self._replicate()
        self._schedule_entry()
        f = self.fields[-1]
        dev_batch = self._device_batch(batch)
        statics = self._statics(optimize_poses, dev_batch["view_ids"].shape[0])
        scal = self._scalars_py()
        new_field, new_pose, new_intr, metrics = train_step(
            FieldState(f["params"], f["opt"]),
            self._pose_dev,
            self.intr,
            dev_batch,
            self._scalar_row(scal),
            statics,
            self._next_noise(statics.cfg),
            f["alpha_volume"],
            StepBranches.of(scal),
            self.mesh,
        )
        f["params"], f["opt"] = new_field.params, new_field.opt
        self._pose_dev = new_pose
        self.intr = new_intr
        self.last_metrics = {k: float(v) for k, v in metrics.items()}

        self._apply_post_step_events()
        if self.is_refining:
            self.rf_iter[-1] += 1
        return self.rf_iter[-1] >= self.n_iters - 1

    def optimizer_step_poses_only(self, batch: dict):
        """One eager test-pose photometric refinement step: only the pose
        window changes (no schedule entry, no rf_iter advance)."""
        self._replicate()
        f = self.fields[-1]
        dev_batch = self._device_batch(batch)
        statics = self._statics(True, dev_batch["view_ids"].shape[0])
        scal = self._scalars_py(pose_only=True)
        _, new_pose, _, metrics = train_step_poses_only(
            FieldState(f["params"], f["opt"]),
            self._pose_dev,
            self.intr,
            dev_batch,
            self._scalar_row(scal),
            statics,
            self._next_noise(statics.cfg),
            f["alpha_volume"],
            StepBranches.of(scal),
            self.mesh,
        )
        self._pose_dev = new_pose
        self.last_metrics = {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------------
    # chunk execution: K steps, replayed as captured graphs on a card
    # ------------------------------------------------------------------

    def plan_chunk(self, dataset, optimize_poses: bool, max_len: int) -> list[dict]:
        """Sample up to max_len batches such that no schedule event (upsample,
        occupancy refresh, can_add_rf, the rescale at rf_iter 1) falls
        strictly inside the chunk; the same host schedule replays in
        run_chunk. Index-only batches when a pixel pool is attached."""
        with profiling.span("plan_chunk", unit="chunk"):
            return self._plan_chunk(dataset, optimize_poses, max_len)

    def _plan_chunk(self, dataset, optimize_poses: bool, max_len: int) -> list[dict]:
        c = self.cfg
        batches = []
        sim_rf_iter = self.rf_iter[-1]
        sim_n_iters = self.n_iters
        # replicate the entry branch the first joint step would run
        if sim_rf_iter == 0:
            sim_n_iters = c.n_iters_per_frame
        elif sim_rf_iter == 1:
            n_tf = int((self.blending_weights[:, -1] > 0).sum())
            sim_n_iters = int(c.n_iters_per_frame * n_tf)
        while len(batches) < max_len:
            batch = dataset.sample(
                c.batch_size, self.is_refining, optimize_poses,
                n_views=c.n_views, values=self.pool is None,
            )
            batches.append(batch)
            if batch["train_test_poses"]:
                continue
            if self._has_post_step_event(sim_rf_iter):
                break  # device-side event right after this step
            if self.is_refining:
                sim_rf_iter += 1
            if sim_rf_iter >= sim_n_iters - 1:
                break  # can_add_rf
            if sim_rf_iter == 1:
                break  # schedule rescale changes lists; re-plan
        return batches

    def attach_pool(self, pool) -> None:
        """Use a DevicePixelPool (data/pool.py) on this model's device:
        batches become index streams and the pixel values are gathered on
        the device inside each step."""
        if pool.device != self.device:
            raise ValueError(f"pool on {pool.device}, model on {self.device}")
        self.pool = pool

    def set_mesh(self, mesh) -> None:
        """Ray-batch data parallelism over `mesh` (parallel/sharding.py, axis
        "data"; None turns it off): every step takes this rank's share of the
        batch and the gradients of the global batch; parameters, optimizer
        state and the pose window are replicated (made equal by a broadcast
        from rank 0 now and after each event that rebuilds them; the pixel
        pool is built by every rank from the same frames); eval splits each
        chunk's rays over the ranks. On a card the chunk's steps are captured
        with their collectives under NCCL; gloo runs a collective on the
        host, which no CUDA graph captures, so under gloo the chunk steps
        eagerly: the backend decides, not an option."""
        self.drop_graphs()
        self.mesh = mesh
        if self.device.type == "cuda":
            capture = mesh is None or captures_collectives(mesh)
            self._graphs = ChunkGraphs(self.device) if capture else None
        self._replicated = False
        # also the mesh's first collective, made eagerly: NCCL creates its
        # communicator there, which it cannot do inside a graph capture
        self._replicate()

    def _replicate(self) -> None:
        """Under a mesh, broadcast the replicated state from rank 0 once
        since it was last rebuilt (the current field's params, Adam state and
        alpha volume, the pose window, the intrinsics)."""
        if self.mesh is None or self._replicated:
            return
        f = self.fields[-1]
        replicate_tree([f["params"], f["opt"], f["alpha_volume"], self._pose_dev, self.intr], self.mesh)
        self._replicated = True

    def run_chunk(self, batches: list[dict], optimize_poses: bool) -> bool:
        """Execute pre-planned batches as one chunk: the same schedule
        bookkeeping as a sequence of optimizer_step /
        optimizer_step_poses_only calls (test-pose batches are pose-only
        steps), the same noise stream, one read-back of the metrics. Returns
        can_add_rf after the last step. While the tracer records: host spans
        for each part (pool_sync, schedule, upload, replay, readback, stamps,
        events), the steps' device stamps read after the read-back, and the
        graphs' captures and replays as counters."""
        if not batches:
            return False
        with profiling.span("run_chunk", unit="chunk"):
            return self._run_chunk(batches, optimize_poses)

    def _schedule(self, batches: list[dict]) -> tuple[list[dict], list[dict], int]:
        """Each step's host scalars and host batch (index streams with a
        pool), advancing the schedule as the steps will; returns them and
        the last joint step's pre-increment rf_iter."""
        scal_seq: list[dict] = []
        host_batches: list[dict] = []
        rf_iter_pre_last = self.rf_iter[-1]
        for b in batches:
            pose_only = bool(b["train_test_poses"])
            if not pose_only:
                self._schedule_entry()
                rf_iter_pre_last = self.rf_iter[-1]
            scal_seq.append(self._scalars_py(pose_only))
            if self.pool is not None:
                hb = {
                    "px": np.asarray(b["idx"], np.int64) % self.pool.n_px,
                    "slots": self.pool.slots_for(b["view_ids"]),
                    "view_ids": np.asarray(b["view_ids"], np.int64) - self.win_start,
                }
            else:
                hb = self._host_batch(b)
            hb["gate"] = self._gate()
            host_batches.append(hb)
            if not pose_only and self.is_refining:
                self.rf_iter[-1] += 1
        return scal_seq, host_batches, rf_iter_pre_last

    def _run_chunk(self, batches: list[dict], optimize_poses: bool) -> bool:
        self._replicate()
        k = len(batches)
        use_pool = self.pool is not None
        with profiling.span("pool_sync"):
            if use_pool:
                self.pool.sync()
        with profiling.span("schedule"):
            scal_seq, host_batches, rf_iter_pre_last = self._schedule(batches)
        with profiling.span("upload"):
            stacked = self._shard({key: np.stack([hb[key] for hb in host_batches]) for key in host_batches[0]},
                                  POOL_SHARDED_KEYS if use_pool else _SHARDED_KEYS, 1)
            stacked = {key: np.ascontiguousarray(v) for key, v in stacked.items()}
            profiling.count("h2d.copies", len(stacked))
            profiling.count("h2d.bytes", sum(v.nbytes for v in stacked.values()))
            stacked = {key: torch.from_numpy(v).to(self.device) for key, v in stacked.items()}
            scalars = stack_scalars(scal_seq, self.device)
            branches = [StepBranches.of(sc) for sc in scal_seq]
            f = self.fields[-1]
            statics = self._statics(optimize_poses, stacked["view_ids"].shape[1])
            # the noise stream of k sequential optimizer_step calls, in step order
            noise = stack_noise([self._next_noise(statics.cfg) for _ in range(k)])
        field_state = FieldState(f["params"], f["opt"])
        recording = profiling.recording()
        graphs = self._graphs
        # without graphs, the loop stamps into a ring of this chunk while recording
        stamps = profiling.train_ring(k, self.device) if recording and graphs is None else None
        captures, replays = (graphs.captures, graphs.replays) if graphs is not None else (0, 0)
        with profiling.span("replay"):
            if use_pool:
                out = train_chunk_pooled(
                    field_state, self._pose_dev, self.intr, self.pool.arrays, stacked, scalars, statics,
                    noise, k, self.pool.n_px, f["alpha_volume"], branches_seq=branches, graphs=graphs,
                    mesh=self.mesh, stamps=stamps,
                )
            else:
                out = train_chunk(
                    field_state, self._pose_dev, self.intr, stacked, scalars, statics, noise, k,
                    f["alpha_volume"], branches_seq=branches, graphs=graphs, mesh=self.mesh, stamps=stamps,
                )
        new_field, self._pose_dev, self.intr, metrics = out
        f["params"], f["opt"] = new_field.params, new_field.opt
        # one read-back per chunk
        with profiling.span("readback"):
            names = list(metrics)
            values = torch.stack([metrics[n] for n in names], dim=1).cpu().numpy()
        self.chunk_metrics = {n: values[:, i] for i, n in enumerate(names)}
        self.last_metrics = {n: float(values[-1, i]) for i, n in enumerate(names)}
        if recording:
            with profiling.span("stamps"):
                profiling.record_steps(graphs.ring if graphs is not None else stamps, k)
            if graphs is not None:
                profiling.count("graph.captures", graphs.captures - captures)
                profiling.count("graph.replays", graphs.replays - replays)

        # device-side events keyed on the last joint step's pre-increment iter
        with profiling.span("events"):
            rf_iter_saved = self.rf_iter[-1]
            self.rf_iter[-1] = rf_iter_pre_last
            self._apply_post_step_events()
            self.rf_iter[-1] = rf_iter_saved
        return self.rf_iter[-1] >= self.n_iters - 1

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def get_cam2world(self, view_ids=None, starting_id: int = 0) -> np.ndarray:
        """[N, 3, 4] camera-to-world poses of every frame (host float32)."""
        self.sync_window_to_host()
        c2w = cam2world_from_params(torch.from_numpy(self.r_all), torch.from_numpy(self.t_all)).numpy()
        if view_ids is not None:
            return c2w[np.asarray(view_ids)]
        return c2w[starting_id:]

    def get_dist_to_last_rf(self) -> float:
        """Distance of the window's last frame from the current field's centre."""
        t_last = self._pose_dev.t[self.win_len - 1].detach().cpu().numpy()
        return float(np.linalg.norm(t_last + self.world2rf[-1]))

    def focal(self, w: int) -> float:
        off = float(self.intr.params["focal_offset"])
        return self.init_focal * off * w / self.W

    def center(self, w: int, h: int) -> np.ndarray:
        rel = self.intr.params["center_rel"].detach().cpu().numpy()
        return np.array([w, h], np.float32) * rel

    # ------------------------------------------------------------------
    # evaluation: blend every field with a nonzero weight
    # ------------------------------------------------------------------

    def _eval_params(self, f: dict):
        """A field's parameters on the device: the current field's own; a
        retired field's host parameters uploaded once and cached, keyed by
        the identity of the host module and the mesh (clear_eval_cache drops
        the copy)."""
        params = f["params"]
        if f is self.fields[-1]:
            return params
        cached = f.get("_dev_cache")
        if cached is not None and cached[0] is params and cached[2] is self.mesh:
            return cached[1]
        dev = TensorfField({k: p.detach().to(self.device) for k, p in params.named_parameters()})
        f["_dev_cache"] = (params, dev, self.mesh)
        return dev

    def _eval_alpha(self, f: dict):
        """A field's alpha volume for eval: the volume itself, which stays on
        the device when the field retires."""
        return f.get("alpha_volume")

    def clear_eval_cache(self):
        """Drop the device copies of retired fields made by _eval_params (a
        full copy of each evaluated field's factor grids; call after a
        render session)."""
        for f in self.fields:
            f.pop("_dev_cache", None)

    @torch.no_grad()
    def forward_eval(
        self,
        ray_ids: np.ndarray,
        view_ids: np.ndarray,
        w: int,
        h: int,
        cam2world: np.ndarray | None = None,
        world2rf: list[np.ndarray] | None = None,
        blending_weights: np.ndarray | None = None,
        chunk: int = 16384,
        test_id: bool = False,
        floater_thresh: float = 0.0,
    ):
        """Render the rays `ray_ids` (pixel ids, rays_per_view of each view
        in `view_ids`, view-major) at w x h, blending every field whose
        weight is nonzero for the views; then exposure (test_id: the mean of
        the neighbours' exposures) and the clip to [0, 1]. One view renders
        whole frames through render_frame, several go chunk by chunk through
        render_chunk; each field renders chunk // n_fields rays at a time.
        Under a mesh whose "data" size divides that chunk, each rank renders
        its contiguous part of every chunk (JAX's _eval_ray_sharding) and
        the frame is gathered on every rank (a sum over "data" of the ranks'
        zero-filled frames), whose callers all go on with it.
        Returns tensors on the model's device: rgb [N, 3], depth [N],
        directions [N, 3], ij [N, 2]."""
        with profiling.span("forward_eval", unit="frame"):
            return self._forward_eval(ray_ids, view_ids, w, h, cam2world, world2rf, blending_weights, chunk,
                                      test_id, floater_thresh)

    def _forward_eval(self, ray_ids, view_ids, w, h, cam2world, world2rf, blending_weights, chunk, test_id,
                      floater_thresh):
        """forward_eval's body in three host spans (prologue, chunks,
        epilogue). While the tracer records, the card stamps the frame's
        entry and end (row 0 of the frame's ring) and each chunk and
        field's start, features and end (one row each)."""
        with profiling.span("prologue"):
            view_ids = np.asarray(view_ids)
            if blending_weights is None:
                blending_weights = self.blending_weights[view_ids]
            active_rf_ids = [int(i) for i in np.nonzero(blending_weights.sum(axis=0))[0]]
            if not active_rf_ids:
                raise RuntimeError("No valid field for the requested views")
            n_rays = ray_ids.shape[0]
            rays_per_view = n_rays // len(view_ids)
            chunk = max(chunk // len(active_rf_ids), 1)
            n_chunks = (n_rays + chunk - 1) // chunk
            n_pad = n_chunks * chunk
            dev = self.device
            ring = profiling.eval_ring(n_chunks * len(active_rf_ids), dev)
            if ring is not None:
                ring.stamp("start")
            self._replicate()
            self.sync_window_to_host()
            if cam2world is None:
                cam2world = self.get_cam2world(view_ids)
            if world2rf is None:
                world2rf = self.world2rf

            focal = self.focal(w)
            center = self.center(w, h)
            kw = dict(
                w=w, h=h, floater_thresh=floater_thresh, fov360=(self.cfg.fov == 360),
                refine=1.0 if self.is_refining else 0.0,
                focal=torch.tensor(focal, dtype=torch.float32, device=dev),
                center=torch.from_numpy(center).to(dev),
            )
            # this rank's rays: [lo, lo + part) of every chunk
            rank, world = (0, 1) if self.mesh is None else data_rank(self.mesh)
            split = world > 1 and chunk % world == 0
            part = chunk // world if split else chunk
            lo = rank * part if split else 0
            ids = torch.from_numpy(np.asarray(ray_ids, np.int64)).to(dev)
            # the last chunk padded with ray id 0: one chunk shape a frame
            ids_p = torch.cat([ids, ids.new_zeros(n_pad - n_rays)])
            bw = torch.from_numpy(np.asarray(blending_weights, np.float32)).to(dev)  # [V, n_rf]
            # the padded frame's blended rgb (columns 0-2) and depth (column 3)
            out = torch.zeros((n_pad, 4), device=dev)

            def cam2rf(c2w: np.ndarray, rf_id: int) -> torch.Tensor:
                c2w = c2w.copy()
                c2w[..., :3, 3] += world2rf[rf_id]
                return torch.from_numpy(np.ascontiguousarray(c2w, np.float32)).to(dev)

            if len(view_ids) > 1:
                # padded rays weigh 0
                bw_exp = torch.cat([bw.repeat_interleave(rays_per_view, dim=0),
                                    bw.new_zeros(n_pad - n_rays, bw.shape[1])])
                c2w_exp = np.repeat(cam2world, rays_per_view, axis=0)
                c2w_exp = np.concatenate([c2w_exp, np.repeat(c2w_exp[-1:], n_pad - n_rays, axis=0)])
                fields = []
                for rf_id in active_rf_ids:
                    f = self.fields[rf_id]
                    params = self._eval_params(f)
                    quad = build_combined_quad_views(params, f["cfg"]) if f["cfg"].fast_gather else None
                    fields.append((rf_id, f, params, quad, cam2rf(c2w_exp, rf_id)))

        with profiling.span("chunks"), profiling.stamping(ring):
            if ring is not None:
                ring.row = 1
            if len(view_ids) == 1:
                mine = (torch.arange(n_chunks, device=dev)[:, None] * chunk + lo
                        + torch.arange(part, device=dev)[None]).reshape(-1)
                for rf_id in active_rf_ids:
                    f = self.fields[rf_id]
                    rgb, depth = render_frame(
                        self._eval_params(f), f["cfg"], ids_p[mine].reshape(n_chunks, part),
                        cam2rf(cam2world[0], rf_id), alpha_volume=self._eval_alpha(f), **kw,
                    )
                    out[mine] += torch.cat([rgb, depth[:, None]], dim=1) * bw[0, rf_id]
            else:
                for ci in range(n_chunks):
                    sl = slice(ci * chunk + lo, ci * chunk + lo + part)
                    for rf_id, f, params, quad, c2rf in fields:
                        profiling.stamp("start")
                        rgb, depth, _, _ = render_chunk(
                            params, f["cfg"], ids_p[sl], c2rf[sl], alpha_volume=self._eval_alpha(f),
                            quad=quad, **kw,
                        )
                        out[sl] += torch.cat([rgb, depth[:, None]], dim=1) * bw_exp[sl, rf_id, None]
                        profiling.stamp("end")
                        if ring is not None:
                            ring.row += 1

        with profiling.span("epilogue"):
            if split:
                all_sum_(out, self.mesh)
            rgbs, depths = out[:n_rays, :3].contiguous(), out[:n_rays, 3].contiguous()

            if self.cfg.lr_exposure_init > 0:
                rgbs = _apply_exposure(
                    rgbs, torch.from_numpy(self.exp_all).to(dev),
                    torch.from_numpy(view_ids.astype(np.int64)).to(dev),
                    rays_per_view, torch.tensor(self.n_frames, device=dev), 1.0 if test_id else 0.0,
                )
            rgbs = torch.clamp(rgbs, 0.0, 1.0)
            if ring is not None:
                ring.row = 0
                ring.stamp("end")

            i = ids % w
            j = (ids // w) % h
            # in float64 and rounded once, as JAX's numpy does
            directions = torch.stack([
                (i.double() + 0.5 - float(center[0])) / focal,
                -(j.double() + 0.5 - float(center[1])) / focal,
                -torch.ones_like(i, dtype=torch.float64),
            ], dim=-1).float()
            return rgbs, depths, directions, torch.stack([i, j], dim=-1)

"""Streaming video dataset with a sliding active-frame window (the port's
copy of localrf_tpu/data/dataset.py, numpy only: the same classes, names
and draws from the same seed, so both packages sample identical batches).

Host-side counterpart of the reference's `LocalRFDataset`
(ref: dataLoader/localrf_dataset.py:24-316): sorted `images/` directory (or
`transforms.json` pose priors), every `test_frame_every`-th frame held out,
lazy chunked decode on a thread pool, flat per-pixel buffers, per-image loss
weights = Laplacian sharpness x motion mask, window maintained through
`activate_frames` / `deactivate_frames`.

The `sample()` batch layout is fixed [n_views=16, px_per_view] for static jit
shapes. A `SyntheticDataset` built from in-memory arrays shares the full
sampler/window logic for tests.
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .flow_io import decode_flow


def _laplacian_var(img: np.ndarray) -> float:
    """Variance of the Laplacian of the grayscale image (sharpness weight,
    ref: dataLoader/localrf_dataset.py:229-234)."""
    import cv2

    gray = cv2.cvtColor((img * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
    return float(cv2.Laplacian(gray, cv2.CV_32F).var())


def _concat_append(old, new_list, dim):
    new = np.concatenate(new_list, 0).reshape(-1, dim)
    if old is not None:
        new = np.concatenate([old, new], 0)
    return new


class BaseDataset:
    """Window/sampling logic shared by the disk and synthetic datasets."""

    split: str
    num_images: int
    test_mask: np.ndarray
    frames_chunk: int
    load_depth: bool
    load_flow: bool

    def _init_window(self, n_init_frames: int):
        self.all_rgbs = None
        self.all_invdepths = None
        self.all_fwd_flow = self.all_fwd_mask = None
        self.all_bwd_flow = self.all_bwd_mask = None
        self.all_loss_weights = None
        self.active_frames_bounds = [0, 0]
        self.loaded_frames = 0
        self._rng = np.random.default_rng(20211202)
        self.activate_frames(n_init_frames)

    # -- window management (ref: localrf_dataset.py:113-139) --

    def activate_frames(self, n_frames: int = 1):
        self.active_frames_bounds[1] = min(
            self.active_frames_bounds[1] + n_frames, self.num_images
        )
        if self.active_frames_bounds[1] > self.loaded_frames:
            self.read_meta()

    def has_left_frames(self) -> bool:
        return self.active_frames_bounds[1] < self.num_images

    def deactivate_frames(self, first_frame: int):
        n_frames = first_frame - self.active_frames_bounds[0]
        self.active_frames_bounds[0] = first_frame
        cut = n_frames * self.n_px_per_frame
        self.all_rgbs = self.all_rgbs[cut:]
        if self.load_depth:
            self.all_invdepths = self.all_invdepths[cut:]
        if self.load_flow:
            self.all_fwd_flow = self.all_fwd_flow[cut:]
            self.all_fwd_mask = self.all_fwd_mask[cut:]
            self.all_bwd_flow = self.all_bwd_flow[cut:]
            self.all_bwd_mask = self.all_bwd_mask[cut:]
        self.all_loss_weights = self.all_loss_weights[cut:]

    def read_meta(self):
        raise NotImplementedError

    # -- batch sampling (ref: localrf_dataset.py:273-316) --

    def sample(
        self,
        batch_size: int,
        is_refining: bool,
        optimize_poses: bool,
        n_views: int = 16,
        values: bool = True,
    ) -> dict:
        b0, b1 = self.active_frames_bounds
        active_test_mask = self.test_mask[b0:b1]
        test_ratio = active_test_mask.mean() if b1 > b0 else 0.0
        if optimize_poses:
            train_test_poses = test_ratio > self._rng.uniform()
        else:
            train_test_poses = False

        inclusion_mask = active_test_mask if train_test_poses else 1 - active_test_mask
        sample_map = np.arange(b0, b1, dtype=np.int64)[inclusion_mask == 1]
        n_incl = int(inclusion_mask.sum())

        raw_samples = self._rng.integers(0, n_incl, n_views).astype(np.int64)
        # Force the newest frames into the batch during coarse optimization
        # (ref: localrf_dataset.py:290-294)
        if not is_refining and n_incl > 4:
            forced = [n_incl - 1, n_incl - 1, n_incl - 2, n_incl - 2, n_incl - 3, n_incl - 4]
            raw_samples[: min(n_views, 6)] = forced[: min(n_views, 6)]

        view_ids = sample_map[raw_samples]

        idx = self._rng.integers(0, self.n_px_per_frame, batch_size).astype(np.int64)
        idx = idx.reshape(n_views, -1)
        idx = idx + view_ids[..., None] * self.n_px_per_frame
        idx = idx.reshape(-1)
        idx_sample = idx - b0 * self.n_px_per_frame

        if not values:
            # index-only batch: pixel values are gathered on device from the
            # pixel pool (data/pool.py)
            return {
                "idx": idx,
                "view_ids": view_ids,
                "train_test_poses": train_test_poses,
            }

        return {
            "rgbs": self.all_rgbs[idx_sample],
            "loss_weights": self.all_loss_weights[idx_sample],
            "invdepths": self.all_invdepths[idx_sample] if self.load_depth else None,
            "fwd_flow": self.all_fwd_flow[idx_sample] if self.load_flow else None,
            "fwd_mask": self.all_fwd_mask[idx_sample] if self.load_flow else None,
            "bwd_flow": self.all_bwd_flow[idx_sample] if self.load_flow else None,
            "bwd_mask": self.all_bwd_mask[idx_sample] if self.load_flow else None,
            "idx": idx,
            "view_ids": view_ids,
            "train_test_poses": train_test_poses,
        }


class LocalRFDataset(BaseDataset):
    """Disk-backed dataset reading images/, depth/, flow_ds/, masks/."""

    def __init__(
        self,
        datadir: str,
        split: str = "train",
        frames_chunk: int = 20,
        downsampling: float = -1,
        load_depth: bool = False,
        load_flow: bool = False,
        with_preprocessed_poses: bool = False,
        n_init_frames: int = 7,
        subsequence=(0, -1),
        test_frame_every: int = 10,
        frame_step: int = 1,
    ):
        self.root_dir = datadir
        self.split = split
        self.frames_chunk = max(frames_chunk, n_init_frames)
        self.downsampling = downsampling
        self.load_depth = load_depth
        self.load_flow = load_flow
        self.frame_step = frame_step

        if with_preprocessed_poses:
            with open(os.path.join(datadir, "transforms.json")) as f:
                self.transforms = json.load(f)
            self.image_paths = sorted(
                os.path.basename(fm["file_path"]) for fm in self.transforms["frames"]
            )
            poses_dict = {
                os.path.basename(fm["file_path"]): fm["transform_matrix"]
                for fm in self.transforms["frames"]
            }
            poses = [
                np.array(poses_dict[p], dtype=np.float32) for p in self.image_paths
            ]
            self.first_pose = poses[0]
            rel = [np.eye(4, dtype=np.float32)]
            for i in range(1, len(poses)):
                rel.append(np.linalg.inv(poses[i - 1]) @ poses[i])
            self.rel_poses = np.stack(rel, 0)
            self.pose_scale = 2e-2 / np.median(
                np.linalg.norm(self.rel_poses[:, :3, 3], axis=-1)
            )
            self.rel_poses[:, :3, 3] *= self.pose_scale
            self.rel_poses = self.rel_poses[::frame_step]
        else:
            self.image_paths = sorted(os.listdir(os.path.join(datadir, "images")))
        if tuple(subsequence) != (0, -1):
            self.image_paths = self.image_paths[subsequence[0] : subsequence[1]]
        self.image_paths = self.image_paths[::frame_step]
        self.all_image_paths = self.image_paths

        self.test_mask, self.test_paths = [], []
        for idx, image_path in enumerate(self.image_paths):
            fbase = os.path.splitext(image_path)[0]
            index = int(fbase) if fbase.isnumeric() else idx
            if test_frame_every > 0 and index % test_frame_every == 0:
                self.test_paths.append(image_path)
                self.test_mask.append(1)
            else:
                self.test_mask.append(0)
        self.test_mask = np.array(self.test_mask)

        if split == "test":
            self.image_paths = self.test_paths
            self.frames_chunk = len(self.image_paths)
        self.num_images = len(self.image_paths)
        self.all_fbases = {
            os.path.splitext(p)[0]: i for i, p in enumerate(self.image_paths)
        }

        self.white_bg = False
        self.near_far = [0.1, 1e3]
        self.scene_bbox = 2 * np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)

        self._init_window(n_init_frames)

    def get_frame_fbase(self, view_id: int) -> str:
        return list(self.all_fbases.keys())[view_id]

    def _read_one(self, i: int) -> dict:
        import cv2

        image_path = os.path.join(self.root_dir, "images", self.image_paths[i])
        fbase = os.path.splitext(self.image_paths[i])[0]
        motion_mask_path = os.path.join(self.root_dir, "masks", f"{fbase}.png")
        if not os.path.isfile(motion_mask_path):
            motion_mask_path = os.path.join(self.root_dir, "masks/all.png")

        img = cv2.imread(image_path)[..., ::-1].astype(np.float32) / 255
        if self.downsampling != -1:
            scale = 1 / self.downsampling
            img = cv2.resize(img, None, fx=scale, fy=scale, interpolation=cv2.INTER_AREA)
        wh = tuple(img.shape[1::-1])

        invdepth = None
        if self.load_depth:
            invdepth_path = os.path.join(self.root_dir, "depth", f"{fbase}.png")
            invdepth = cv2.imread(invdepth_path, -1).astype(np.float32)
            invdepth = cv2.resize(invdepth, wh, interpolation=cv2.INTER_AREA)

        fwd_flow = fwd_mask = bwd_flow = bwd_mask = None
        if self.load_flow:
            glob_idx = self.all_image_paths.index(self.image_paths[i])
            nxt = (
                self.all_image_paths[glob_idx + 1]
                if glob_idx + 1 < len(self.all_image_paths)
                else self.all_image_paths[0]
            )
            prefix = f"step{self.frame_step}_" if self.frame_step != 1 else ""
            fwd_path = os.path.join(
                self.root_dir, "flow_ds", f"fwd_{prefix}{os.path.splitext(nxt)[0]}.png"
            )
            bwd_path = os.path.join(self.root_dir, "flow_ds", f"bwd_{prefix}{fbase}.png")
            enc_fwd = cv2.imread(fwd_path, cv2.IMREAD_UNCHANGED)
            enc_bwd = cv2.imread(bwd_path, cv2.IMREAD_UNCHANGED)
            flow_scale = img.shape[0] / enc_fwd.shape[0]
            enc_fwd = cv2.resize(enc_fwd, wh, interpolation=cv2.INTER_AREA)
            enc_bwd = cv2.resize(enc_bwd, wh, interpolation=cv2.INTER_AREA)
            fwd_flow, fwd_mask = decode_flow(enc_fwd)
            bwd_flow, bwd_mask = decode_flow(enc_bwd)
            fwd_flow *= flow_scale
            bwd_flow *= flow_scale

        mask = None
        if os.path.isfile(motion_mask_path):
            mask = cv2.imread(motion_mask_path, cv2.IMREAD_UNCHANGED)
            if mask.ndim != 2:
                mask = mask[..., 0]
            mask = cv2.resize(mask, wh, interpolation=cv2.INTER_AREA) > 0

        return {
            "img": img,
            "invdepth": invdepth,
            "fwd_flow": fwd_flow,
            "fwd_mask": fwd_mask,
            "bwd_flow": bwd_flow,
            "bwd_mask": bwd_mask,
            "mask": mask,
        }

    def prefetch_next_chunk(self):
        """Start decoding the next chunk on background threads so frame
        activation doesn't stall the training loop (the reference decodes
        synchronously at activation time, ref: localrf_dataset.py:216-219)."""
        if getattr(self, "_prefetch", None) is not None:
            return
        lo = self.loaded_frames
        n_load = min(self.frames_chunk, self.num_images - lo)
        if n_load <= 0:
            return
        pool = ThreadPoolExecutor(max_workers=8)
        futures = [pool.submit(self._read_one, i) for i in range(lo, lo + n_load)]
        self._prefetch = (lo, futures, pool)

    def read_meta(self):
        lo = self.loaded_frames
        n_load = min(self.frames_chunk, self.num_images - lo)
        pre = getattr(self, "_prefetch", None)
        if pre is not None and pre[0] == lo:
            _, futures, pool = pre
            all_data = [f.result() for f in futures[:n_load]]
            pool.shutdown(wait=False)
            self._prefetch = None
        else:
            with ThreadPoolExecutor() as pool:
                all_data = list(pool.map(self._read_one, range(lo, lo + n_load)))
        self.loaded_frames += n_load

        rgbs = [d["img"] for d in all_data]
        laplacians = [np.ones_like(d["img"][..., 0]) * _laplacian_var(d["img"]) for d in all_data]
        weights = [
            lap if d["mask"] is None else lap * d["mask"]
            for lap, d in zip(laplacians, all_data)
        ]

        self.img_wh = list(rgbs[0].shape[1::-1])
        self.n_px_per_frame = self.img_wh[0] * self.img_wh[1]

        if self.split != "train":
            self.all_rgbs = np.stack(rgbs, 0)
            if self.load_depth:
                self.all_invdepths = np.stack([d["invdepth"] for d in all_data], 0)
            if self.load_flow:
                self.all_fwd_flow = np.stack([d["fwd_flow"] for d in all_data], 0)
                self.all_fwd_mask = np.stack([d["fwd_mask"] for d in all_data], 0)
                self.all_bwd_flow = np.stack([d["bwd_flow"] for d in all_data], 0)
                self.all_bwd_mask = np.stack([d["bwd_mask"] for d in all_data], 0)
        else:
            self.all_rgbs = _concat_append(self.all_rgbs, rgbs, 3)
            if self.load_depth:
                self.all_invdepths = _concat_append(
                    self.all_invdepths, [d["invdepth"] for d in all_data], 1
                )
            if self.load_flow:
                self.all_fwd_flow = _concat_append(
                    self.all_fwd_flow, [d["fwd_flow"] for d in all_data], 2
                )
                self.all_fwd_mask = _concat_append(
                    self.all_fwd_mask, [d["fwd_mask"] for d in all_data], 1
                )
                self.all_bwd_flow = _concat_append(
                    self.all_bwd_flow, [d["bwd_flow"] for d in all_data], 2
                )
                self.all_bwd_mask = _concat_append(
                    self.all_bwd_mask, [d["bwd_mask"] for d in all_data], 1
                )
            self.all_loss_weights = _concat_append(self.all_loss_weights, weights, 1)


class SyntheticDataset(BaseDataset):
    """In-memory dataset over [N, H, W, 3] arrays — shares the window and
    sampler logic; used by tests and micro-benchmarks."""

    def __init__(
        self,
        rgbs: np.ndarray,
        split: str = "train",
        invdepths: np.ndarray | None = None,
        fwd_flow: np.ndarray | None = None,
        fwd_mask: np.ndarray | None = None,
        bwd_flow: np.ndarray | None = None,
        bwd_mask: np.ndarray | None = None,
        n_init_frames: int = 5,
        test_frame_every: int = 10,
        frames_chunk: int = 20,
    ):
        self.split = split
        self.frames_chunk = max(frames_chunk, n_init_frames)
        self.load_depth = invdepths is not None
        self.load_flow = fwd_flow is not None
        self._src = {
            "rgbs": rgbs.astype(np.float32),
            "invdepths": invdepths,
            "fwd_flow": fwd_flow,
            "fwd_mask": fwd_mask,
            "bwd_flow": bwd_flow,
            "bwd_mask": bwd_mask,
        }
        n = rgbs.shape[0]
        self.test_mask = np.array(
            [1 if (test_frame_every > 0 and i % test_frame_every == 0) else 0 for i in range(n)]
        )
        if split == "test":
            keep = self.test_mask == 1
            for k, v in self._src.items():
                if v is not None:
                    self._src[k] = v[keep]
            n = int(keep.sum())
            self.frames_chunk = max(n, 1)
        self.num_images = n
        self.all_fbases = {f"{i:06d}": i for i in range(n)}
        self.img_wh = [rgbs.shape[2], rgbs.shape[1]]
        self.n_px_per_frame = self.img_wh[0] * self.img_wh[1]
        self.white_bg = False
        self.near_far = [0.1, 1e3]
        self.scene_bbox = 2 * np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
        self.all_image_paths = [f"{i:06d}.jpg" for i in range(n)]
        self._init_window(n_init_frames)

    def get_frame_fbase(self, view_id: int) -> str:
        return f"{view_id:06d}"

    def read_meta(self):
        n_load = min(self.frames_chunk, self.num_images - self.loaded_frames)
        lo = self.loaded_frames
        sl = slice(lo, lo + n_load)
        self.loaded_frames += n_load

        rgbs = [self._src["rgbs"][i] for i in range(sl.start, sl.stop)]
        weights = [np.ones_like(r[..., 0]) for r in rgbs]

        if self.split != "train":
            self.all_rgbs = np.stack(rgbs, 0)
            if self.load_depth:
                self.all_invdepths = self._src["invdepths"][sl].copy()
            if self.load_flow:
                self.all_fwd_flow = self._src["fwd_flow"][sl].copy()
                self.all_fwd_mask = self._src["fwd_mask"][sl].copy()
                self.all_bwd_flow = self._src["bwd_flow"][sl].copy()
                self.all_bwd_mask = self._src["bwd_mask"][sl].copy()
        else:
            self.all_rgbs = _concat_append(self.all_rgbs, rgbs, 3)
            if self.load_depth:
                self.all_invdepths = _concat_append(
                    self.all_invdepths, [self._src["invdepths"][i] for i in range(sl.start, sl.stop)], 1
                )
            if self.load_flow:
                self.all_fwd_flow = _concat_append(
                    self.all_fwd_flow, [self._src["fwd_flow"][i] for i in range(sl.start, sl.stop)], 2
                )
                self.all_fwd_mask = _concat_append(
                    self.all_fwd_mask, [self._src["fwd_mask"][i] for i in range(sl.start, sl.stop)], 1
                )
                self.all_bwd_flow = _concat_append(
                    self.all_bwd_flow, [self._src["bwd_flow"][i] for i in range(sl.start, sl.stop)], 2
                )
                self.all_bwd_mask = _concat_append(
                    self.all_bwd_mask, [self._src["bwd_mask"][i] for i in range(sl.start, sl.stop)], 1
                )
            self.all_loss_weights = _concat_append(self.all_loss_weights, weights, 1)

"""CLI / config-file flag surface (PyTorch port of localrf_tpu/config.py;
ref: opt.py:6-201).

The JAX package's flags with its defaults, and its `--config` file support
(simple `key = value` files, compatible with the reference's
configargparse ones). `--device` picks the torch device (default `cuda`).
The JAX package's XLA-only flags still parse; each is listed in
INERT_FLAGS with the reason it changes nothing here.
"""
from __future__ import annotations

import argparse
import shlex

# --model_name -> TensorfConfig.decomposition (TensoRF's model classes)
MODEL_NAMES = {"TensorVMSplit": "vm", "TensorCP": "cp"}


def _add_config_file_args(argv: list[str]) -> list[str]:
    """Expand `--config file` into its `key = value` lines (CLI wins)."""
    if "--config" not in argv:
        return argv
    i = argv.index("--config")
    path = argv[i + 1]
    rest = argv[:i] + argv[i + 2 :]
    file_args: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" in line:
                key, val = (p.strip() for p in line.split("=", 1))
            else:
                parts = line.split(None, 1)
                key, val = parts[0], parts[1] if len(parts) > 1 else ""
            vals = shlex.split(val)
            vals = [v for v in vals if v not in ("[", "]")]
            vals = [v.strip("[],") for v in vals]
            file_args += [f"--{key}"] + vals
    # file args first so explicit CLI flags override them
    return file_args + rest


# Flags that are parsed but deliberately have no runtime effect, with the
# reason. Every other flag is consumed somewhere in the package
# (tests/test_torch_cli.py enforces this inventory).
_XLA_GATHER = (
    "the JAX package's XLA gather-emitter workaround (the same math in one"
    " dispatch on a TPU); the port gathers per table — train._make_model"
    " warns when it is set"
)
INERT_FLAGS: dict[str, str] = {
    "config": "consumed by the parser itself (_add_config_file_args)",
    "matmul_precision": (
        "JAX's jax_default_matmul_precision for the TPU's single-pass bf16"
        " dots; the port's f32 matmuls are full f32 (TF32 stays off), so every"
        " value computes as 'highest'"
    ),
    "fused_plane_gather": _XLA_GATHER,
    "fused_line_gather": _XLA_GATHER,
    "fused_fwd_gather": _XLA_GATHER,
    "app_top_k": (
        "stored in TensorfConfig.app_top_k as the JAX package stores it; it"
        " steers the grid-sample route (TensorfConfig.fast_gather=False),"
        " which shades the top-K samples of each ray, and the CLI always"
        " takes the quad-gather route (fast_gather=True), which shades densely"
    ),
}


def config_parser(cmd: str | list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None, help="config file path")
    parser.add_argument("--logdir", type=str, default="./log")
    parser.add_argument("--datadir", type=str, default="./data/llff/fern")
    parser.add_argument("--progress_refresh_rate", type=int, default=200)
    parser.add_argument("--downsampling", type=float, default=-1)
    parser.add_argument(
        "--model_name", type=str, default="TensorVMSplit", choices=list(MODEL_NAMES),
        help="the field: TensoRF-VM (TensorVMSplit, LocalRF's) or TensoRF-CP (TensorCP: one"
        " rank a kind, e.g. --n_lamb_sigma 96 --n_lamb_sh 288)",
    )
    # loader
    parser.add_argument("--batch_size", type=int, default=4096)
    parser.add_argument("--n_views", type=int, default=16)
    # learning rates
    parser.add_argument("--lr_R_init", type=float, default=5e-3)
    parser.add_argument("--lr_t_init", type=float, default=5e-4)
    parser.add_argument("--lr_i_init", type=float, default=0)
    parser.add_argument("--lr_exposure_init", type=float, default=1e-3)
    parser.add_argument("--lr_init", type=float, default=0.02)
    parser.add_argument("--lr_basis", type=float, default=1e-3)
    parser.add_argument("--lr_decay_target_ratio", type=float, default=0.1)
    parser.add_argument("--lr_upsample_reset", type=int, default=1)
    # scheduling
    parser.add_argument("--N_voxel_init", type=int, default=64**3)
    parser.add_argument("--N_voxel_final", type=int, default=640**3)
    parser.add_argument("--n_iters_per_frame", type=int, default=600)
    parser.add_argument("--n_iters_reg", type=int, default=100)
    parser.add_argument(
        "--upsamp_list", type=int, default=[100, 150, 200, 250, 300], nargs="+"
    )
    parser.add_argument(
        "--update_AlphaMask_list", type=int, default=[100, 200, 300], nargs="+"
    )
    parser.add_argument("--refinement_speedup_factor", type=float, default=1.0)
    # progressive optimization
    parser.add_argument("--n_init_frames", type=int, default=5)
    parser.add_argument("--max_drift", type=float, default=1)
    parser.add_argument("--n_max_frames", type=int, default=100)
    parser.add_argument("--add_frames_every", type=int, default=100)
    parser.add_argument("--n_overlap", type=int, default=30)
    parser.add_argument("--prog_speedup_factor", type=float, default=1.0)
    # losses
    parser.add_argument("--loss_depth_weight_inital", type=float, default=0.1)
    parser.add_argument("--loss_flow_weight_inital", type=float, default=1)
    parser.add_argument("--L1_weight", type=float, default=1e-2)
    parser.add_argument("--TV_weight_density", type=float, default=0.0)
    parser.add_argument("--TV_weight_app", type=float, default=0.0)
    # model
    parser.add_argument("--n_lamb_sigma", type=int, default=[8, 8, 8], nargs="+")
    parser.add_argument("--n_lamb_sh", type=int, default=[24, 24, 24], nargs="+")
    parser.add_argument("--data_dim_color", type=int, default=27)
    parser.add_argument("--rm_weight_mask_thre", type=float, default=0.001)
    parser.add_argument("--alpha_mask_thre", type=float, default=0.0001)
    parser.add_argument("--distance_scale", type=float, default=25)
    parser.add_argument("--density_shift", type=float, default=-5)
    # network decoder
    parser.add_argument("--shadingMode", type=str, default="MLP_Fea_late_view")
    parser.add_argument("--pos_pe", type=int, default=0)
    parser.add_argument("--view_pe", type=int, default=0)
    parser.add_argument("--fea_pe", type=int, default=0)
    parser.add_argument("--featureC", type=int, default=128)
    # ckpt / render
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--render_only", type=int, default=0)
    parser.add_argument("--render_test", type=int, default=1)
    parser.add_argument("--render_path", type=int, default=1)
    parser.add_argument("--render_from_file", type=str, default="")
    parser.add_argument("--skip_saving_video", action="store_true")
    parser.add_argument("--skip_TB_images", action="store_true")
    # rendering
    parser.add_argument("--fea2denseAct", type=str, default="softplus")
    parser.add_argument(
        "--nSamples", type=int, default=int(1e6),
        help="cap on march samples per ray; effective count ="
        " min(nSamples, aabbDiag/stepSize + 1) (ref: tensorBase.py:317-327)",
    )
    parser.add_argument("--step_ratio", type=float, default=0.5)
    # camera
    parser.add_argument("--fov", type=float, default=85.6)
    parser.add_argument("--with_preprocessed_poses", type=int, default=0)
    parser.add_argument("--subsequence", default=[0, -1], type=int, nargs=2)
    parser.add_argument("--frame_step", type=int, default=1)
    parser.add_argument("--test_frame_every", default=10, type=int)
    # logging
    parser.add_argument("--vis_every", type=int, default=10000)
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device of the model, the pixel pool and the renders"
        " (cuda, cuda:1, cpu)",
    )
    # the JAX package's extras
    parser.add_argument(
        "--use_pallas", type=int, default=1,
        help="the hand-written compositing kernel (K1, ops/kernels/composite.py);"
        " 0 = the plain cumprod compositing",
    )
    parser.add_argument(
        "--seed", type=int, default=20211202,
        help="RNG seed for pixel sampling / init (reference hardcodes"
        " 20211202 at train.py:648; exposed here for variance studies)",
    )
    parser.add_argument(
        "--line_bwd", type=str, default="onehot",
        choices=["gather", "segsum", "onehot"],
        help="backward of the line-factor gathers: autograd's scatter, the"
        " fixed-order segment-sum kernel (K3), or an f32 index_add_ (default)",
    )
    parser.add_argument(
        "--binned_scatter", type=int, default=1,
        help="plane-table backward through the segment-sum kernel (K2);"
        " 0 = autograd's scatter everywhere",
    )
    parser.add_argument(
        "--binned_min_rows", type=int, default=2000,
        help="minimum plane-table row count for the segment-sum kernel"
        " (below it autograd's scatter is used; the default only excludes"
        " tables smaller than the 64^3 stage's 4,096 rows)",
    )
    parser.add_argument(
        "--matmul_precision", type=str, default="default",
        choices=["default", "high", "highest"],
        help="inert in the port (config.INERT_FLAGS): its f32 matmuls are full f32",
    )
    parser.add_argument(
        "--fused_plane_gather", type=int, default=0,
        help="inert in the port (config.INERT_FLAGS): an XLA gather workaround",
    )
    parser.add_argument(
        "--fused_line_gather", type=int, default=0,
        help="inert in the port (config.INERT_FLAGS): an XLA gather workaround",
    )
    parser.add_argument(
        "--fused_fwd_gather", type=int, default=0, choices=[0, 1, 2],
        help="inert in the port (config.INERT_FLAGS): an XLA gather workaround",
    )
    parser.add_argument(
        "--fused_march", type=int, default=1,
        help="fuse the march core (plane-row lerp, line lookup, factor product,"
        " basis matmul, shading MLP) into one kernel with its VJP (K4,"
        " ops/kernels/march.py); only for the reference's default shape"
        " config (VM 8/24, app_dim 27, featureC 128, MLP_Fea_late_view, no"
        " PE, a cubic grid), any other takes the unfused path. On by default"
        " in the port (the JAX package's default is 0); 0 forces the unfused"
        " path. A checkpoint keeps the value it was written with, so a JAX"
        " checkpoint loads with 0",
    )
    parser.add_argument(
        "--data_parallel", type=int, default=0,
        help="ranks to shard the ray batch over, one a card (0 = the launch's"
        " WORLD_SIZE); more than 1 needs that many ranks from"
        " python -m torch.distributed.run --nproc_per_node N, else it raises",
    )
    parser.add_argument(
        "--resume", type=int, default=0,
        help="resume mid-training from logdir/checkpoints_tmp.th (or"
        " checkpoints.th) if present, optimizer state included",
    )
    parser.add_argument(
        "--app_top_k", type=int, default=128,
        help="top-K appearance shading of the grid-sample route; inert from"
        " the CLI, which takes the quad-gather route (config.INERT_FLAGS)",
    )
    parser.add_argument(
        "--gather_dtype", type=str, default="bfloat16",
        choices=["float32", "bfloat16"],
        help="dtype of the derived factor-grid gather tables (canonical"
        " params stay float32); bfloat16 rounds interpolation weights to bf16",
    )
    parser.add_argument(
        "--mlp_dtype", type=str, default="bfloat16",
        choices=["float32", "bfloat16"],
        help="compute dtype of the shading MLP and basis matmul (master"
        " weights stay float32)",
    )
    parser.add_argument(
        "--moment_dtype", type=str, default="float32",
        choices=["float32", "bfloat16"],
        help="storage dtype of the field optimizer's Adam moments (update"
        " math stays float32)",
    )
    parser.add_argument(
        "--occ_ratio", type=float, default=0.45,
        help="occupancy compaction: fraction of march samples kept once an"
        " alpha volume exists (exact while fewer are occupied)",
    )
    parser.add_argument(
        "--occ_min", type=int, default=256,
        help="occupancy compaction floor (samples per ray)",
    )
    parser.add_argument(
        "--occ_probe_ds", type=int, default=4,
        help="coarse march probe: probe the ds-pooled, dilated alpha volume"
        " once per group of ds march samples; 0 = the exact per-sample cull",
    )
    parser.add_argument(
        "--occ_refine", type=int, default=1,
        help="with --occ_probe_ds: also apply the exact fine-volume cull at"
        " the selected samples",
    )
    parser.add_argument(
        "--pixel_pool", type=int, default=1,
        help="keep the active window's pixel data on the device and gather"
        " training batches there (the host ships only sample indices)",
    )
    parser.add_argument(
        "--scan_chunk", type=int, default=16,
        help="steps a chunk: each step a replayed CUDA graph on a card"
        " (1 = step at a time)",
    )

    if cmd is not None:
        argv = shlex.split(cmd) if isinstance(cmd, str) else list(cmd)
    else:
        import sys

        argv = sys.argv[1:]
    argv = _add_config_file_args(argv)
    return parser.parse_args(argv)

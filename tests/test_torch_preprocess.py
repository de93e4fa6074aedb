"""The port's preprocessing (localrf_tpu_torch/preprocess/) against the JAX
package's on the CPU: RAFT piece by piece and whole, its checkpoint names,
the flow CLI, DPT at narrow widths (also below image_size, where the
antialiased resize matters) and the depth CLI.

Inputs and weights come from numpy seeds. Weights reach the port through
`convert.raft_from_jax` / `convert.dpt_from_jax` from JAX's own trees.
Tolerances: RAFT's pieces 1e-5 relative to their largest entry (f32 convs
summed in another order), the whole RAFT 1e-5 of the flow's scale
(measured 9e-7 at 128x160, 3 iterations); DPT 1e-4 of the depth's maximum
(measured 6e-6-1.4e-5); the CLIs' outputs within one encoding step
(flows, 1/256 px) or a stated count of pixels (masks, uint16 depth).
"""
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from localrf_tpu.preprocess import raft as jraft
from localrf_tpu_torch.convert import raft_from_jax
from localrf_tpu_torch.preprocess import raft as traft

from raft_things_manifest import OFFICIAL_RAFT_THINGS_MANIFEST


def official_state_dict(seed: int = 0) -> dict[str, np.ndarray]:
    """A random raft-things.pth (numpy), key for key the official listing:
    conv weights normal / sqrt(fan in), biases small, batch norms with
    non-trivial affine terms and running statistics."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in OFFICIAL_RAFT_THINGS_MANIFEST.items():
        leaf = key.rsplit(".", 1)[1]
        is_norm = ".norm" in key
        if leaf == "num_batches_tracked":
            v = np.array(0, np.int64)
        elif len(shape) == 4:
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape[1:])), shape)
        elif leaf == "running_var" or (is_norm and leaf == "weight"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.normal(0, 0.1 if is_norm else 0.05, shape)
        sd[key] = v.astype(v.dtype if leaf == "num_batches_tracked" else np.float32)
    return sd


@pytest.fixture(scope="module")
def raft_pair():
    """(JAX params, the port's RAFT) from one random official state dict."""
    from localrf_tpu.preprocess.convert import convert_raft_state_dict

    sd = {k.removeprefix("module."): v for k, v in official_state_dict().items()}
    params = convert_raft_state_dict(sd)
    model = traft.RAFT()
    model.load_state_dict(raft_from_jax(params), strict=True)
    return jax.tree.map(jnp.asarray, params), model


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("kind", ["instance", "batch"])
def test_raft_encoder_matches_jax(raft_pair, kind):
    """fnet (instance norm: biased variance, eps 1e-5) and cnet (batch norm
    from running statistics) at 1/8 resolution: 1e-5 of the largest entry."""
    params, model = raft_pair
    x = np.random.default_rng(1).uniform(-1, 1, (2, 40, 56, 3)).astype(np.float32)
    enc, net = ("fnet", model.fnet) if kind == "instance" else ("cnet", model.cnet)
    ref = np.asarray(jraft.encoder_apply(params[enc], x, kind))
    with torch.no_grad():
        got = net(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 5, 7, 256)
    assert _rel_err(got, ref) < 1e-5


def test_corr_pyramid_matches_jax_on_odd_sizes():
    """An odd 9x11 map pools (floored) to 4x5, 2x2 and 1x1, each level equal
    to JAX's reduce_window "VALID" mean within 1e-6 of its largest entry."""
    rng = np.random.default_rng(2)
    f1, f2 = (rng.normal(size=(2, 9, 11, 16)).astype(np.float32) for _ in range(2))
    ref = jraft.build_corr_pyramid(f1, f2)
    got = traft.build_corr_pyramid(_nchw(f1), _nchw(f2))
    assert [tuple(g.shape[2:]) for g in got] == [(9, 11), (4, 5), (2, 2), (1, 1)]
    for g, r in zip(got, ref):
        assert _rel_err(g[:, 0].numpy(), np.asarray(r)[..., 0]) < 1e-6


def test_corr_lookup_matches_jax_off_the_edge():
    """Fractional coords, many of them off the map, where each corner reads
    zero on its own: equal to JAX's lookup within 1e-6."""
    rng = np.random.default_rng(3)
    f1, f2 = (rng.normal(size=(1, 12, 16, 8)).astype(np.float32) for _ in range(2))
    coords = rng.uniform(-6, 22, (1, 12, 16, 2)).astype(np.float32)
    ref = np.asarray(jraft.corr_lookup(jraft.build_corr_pyramid(f1, f2), coords))
    got = traft.corr_lookup(traft.build_corr_pyramid(_nchw(f1), _nchw(f2)), _nchw(coords))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (1, 12, 16, 4 * 81)
    assert (ref == 0).any() and np.abs(got - ref).max() < 1e-6 * np.abs(ref).max()


def test_corr_lookup_tap_order_puts_x_slowest():
    """On a level-0 volume whose value at (x, y) is 100 y + x, tap k of a
    point at integer (cx, cy) reads 100 (cy + dy) + (cx + dx) with
    dx = k // 9 - 4 (slowest) and dy = k % 9 - 4: the official convc1 order."""
    h = w = 20
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32), torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    level0 = (100 * ys + xs).expand(h * w, h, w)[:, None]
    pyramid = [level0] + [level0[:, :, :0, :0]] * 3
    coords = torch.zeros(1, 2, h, w)
    coords[0, 0], coords[0, 1] = 9.0, 11.0  # every point looks around (9, 11)
    taps = traft.corr_lookup(pyramid, coords)[0, :81, 0, 0]
    k = torch.arange(81)
    assert torch.equal(taps, 100 * (11 + k % 9 - 4) + (9 + k // 9 - 4).float())


def test_convex_upsample_matches_jax():
    """The mask channel k*64 + u*8 + v, neighbourhood dy outer, dx inner:
    equal to JAX's within 1e-5 of the largest entry."""
    rng = np.random.default_rng(4)
    flow = rng.normal(size=(2, 5, 7, 2)).astype(np.float32)
    mask = rng.normal(size=(2, 5, 7, 576)).astype(np.float32)
    ref = np.asarray(jraft.convex_upsample(flow, mask))
    got = traft.convex_upsample(_nchw(flow), _nchw(mask)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 40, 56, 2)
    assert _rel_err(got, ref) < 1e-5


def test_sep_conv_gru_matches_jax(raft_pair):
    """The 1x5 then 5x1 ConvGRU: 1e-5 of the largest entry."""
    params, model = raft_pair
    rng = np.random.default_rng(5)
    h = np.tanh(rng.normal(size=(2, 6, 9, 128))).astype(np.float32)
    x = rng.normal(size=(2, 6, 9, 256)).astype(np.float32)
    ref = np.asarray(jraft.sep_conv_gru_apply(params["update"]["gru"], h, x))
    with torch.no_grad():
        got = model.update_block.gru(_nchw(h), _nchw(x)).permute(0, 2, 3, 1).numpy()
    assert _rel_err(got, ref) < 1e-5


def test_raft_matches_jax_raft_apply(raft_pair):
    """The whole network at 128x160 with 3 iterations, a batch of two (the
    fwd / bwd pair): within 1e-5 of the flow's scale (measured 9e-7)."""
    params, model = raft_pair
    rng = np.random.default_rng(6)
    im1 = rng.uniform(0, 255, (1, 128, 160, 3)).astype(np.float32)
    im2 = np.clip(im1 + rng.normal(0, 8, im1.shape).astype(np.float32), 0, 255)
    a, b = np.concatenate([im1, im2]), np.concatenate([im2, im1])
    ref = np.asarray(jraft.raft_apply(params, a, b, iters=3))
    got = model(_nchw(a), _nchw(b), iters=3).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 128, 160, 2)
    assert np.abs(got - ref).max() < 1e-5 * max(np.abs(ref).max(), 1.0)


def test_raft_state_dict_is_the_official_listing():
    """The port's RAFT, with "module." added back, has exactly the official
    raft-things.pth keys and shapes (num_batches_tracked included)."""
    sd = traft.RAFT().state_dict()
    assert {f"module.{k}": tuple(v.shape) for k, v in sd.items()} == OFFICIAL_RAFT_THINGS_MANIFEST


@pytest.mark.parametrize("twins", [False, True])
def test_load_raft_checkpoint_equals_jax_convert(tmp_path, twins):
    """A torch.save'd random official dict loads through
    load_raft_checkpoint (strict), and the port's state equals JAX's
    convert_raft_checkpoint of the same file carried by raft_from_jax. With
    `twins`, the file also lists each strided batch norm as downsample.1
    (the official module registers norm3 twice): those load too."""
    from localrf_tpu.preprocess.convert import convert_raft_checkpoint
    from localrf_tpu_torch.preprocess.convert import load_raft_checkpoint

    sd = {k: torch.from_numpy(v) for k, v in official_state_dict(7).items()}
    if twins:
        sd.update({k.replace(".norm3.", ".downsample.1."): v.clone() for k, v in sd.items() if ".norm3." in k})
    path = str(tmp_path / "raft-things.pth")
    torch.save(sd, path)
    got = load_raft_checkpoint(path, device="cpu").state_dict()
    want = raft_from_jax(convert_raft_checkpoint(path))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if twins:
        key = "module.cnet.layer2.0.downsample.1.weight"
        sd[key] = sd[key] + 1.0
        torch.save(sd, path)
        with pytest.raises(ValueError, match="differs from its norm3"):
            load_raft_checkpoint(path, device="cpu")


@pytest.mark.parametrize("h,w", [(37, 45), (40, 48), (270, 480)])
def test_input_padder_matches_jax(h, w):
    """Pads to multiples of 8 with edge values, split as JAX splits it, and
    crops back."""
    x = np.random.default_rng(8).uniform(0, 255, (2, h, w, 3)).astype(np.float32)
    jp, tp = jraft.InputPadder(x.shape), traft.InputPadder(_nchw(x).shape)
    ref = np.asarray(jp.pad(x))
    got = tp.pad(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape and got.shape[1] % 8 == 0 and got.shape[2] % 8 == 0
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tp.unpad(_nchw(ref)).permute(0, 2, 3, 1).numpy(), x)


def test_compute_fwdbwd_mask_matches_jax():
    """The cycle-consistency masks of consistent, noisy and inconsistent
    flows equal JAX's."""
    from localrf_tpu.preprocess.run_flow import compute_fwdbwd_mask as jmask
    from localrf_tpu_torch.preprocess.run_flow import compute_fwdbwd_mask as tmask

    rng = np.random.default_rng(9)
    fwd = rng.normal(0, 2, (30, 40, 2)).astype(np.float32)
    for bwd in (-fwd, -fwd + rng.normal(0, 1, fwd.shape).astype(np.float32), np.full_like(fwd, 30.0)):
        for got, want in zip(tmask(fwd, bwd), jmask(fwd, bwd)):
            np.testing.assert_array_equal(got, want)


def _images(scene: str, n: int, h: int, w: int, seed: int) -> None:
    import cv2

    os.makedirs(os.path.join(scene, "images"))
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h, w, 3))
    for i in range(n):
        img = np.clip(np.roll(base, 2 * i, axis=1) + rng.normal(0, 4, base.shape), 0, 255)
        cv2.imwrite(os.path.join(scene, "images", f"{i:06d}.jpg"), img.astype(np.uint8))


def test_run_flow_matches_jax(tmp_path):
    """run_flow on a 3-frame 40x48 scene, --iters 2, the same weights file:
    the same 4 flow_ds/ files (and flow_vis/), decoded flows within one
    encoding step (1/256 px), masks equal but for at most 2 pixels a file
    (a flow within an f32 ulp of the consistency threshold). Then the
    port's dataset reads the scene back with its flows: the last frame,
    which has no pair, reads as zero flow, masked out."""
    import cv2

    from localrf_tpu.preprocess import run_flow as jrun
    from localrf_tpu_torch.data.dataset import LocalRFDataset
    from localrf_tpu_torch.data.flow_io import decode_flow
    from localrf_tpu_torch.preprocess import run_flow as trun

    ckpt = str(tmp_path / "raft.pth")
    torch.save({k: torch.from_numpy(v) for k, v in official_state_dict(10).items()}, ckpt)
    jscene, tscene = str(tmp_path / "jax"), str(tmp_path / "port")
    _images(jscene, 3, 40, 48, seed=11)
    shutil.copytree(jscene, tscene)
    jrun.main(["--data_dir", jscene, "--ckpt", ckpt, "--iters", "2"])
    trun.main(["--data_dir", tscene, "--ckpt", ckpt, "--iters", "2", "--device", "cpu"])

    names = sorted(os.listdir(os.path.join(jscene, "flow_ds")))
    assert names == ["bwd_000000.png", "bwd_000001.png", "fwd_000001.png", "fwd_000002.png"]
    assert names == sorted(os.listdir(os.path.join(tscene, "flow_ds")))
    assert sorted(os.listdir(os.path.join(tscene, "flow_vis"))) == [n[:-4] + ".jpg" for n in names]
    for n in names:
        jflow, jm = decode_flow(cv2.imread(os.path.join(jscene, "flow_ds", n), cv2.IMREAD_UNCHANGED))
        tflow, tm = decode_flow(cv2.imread(os.path.join(tscene, "flow_ds", n), cv2.IMREAD_UNCHANGED))
        assert tflow.shape == (20, 24, 2) and np.isfinite(tflow).all()
        assert np.abs(tflow - jflow).max() <= 1 / 256, n
        assert int((tm != jm).sum()) <= 2, n

    ds = LocalRFDataset(tscene, load_flow=True, n_init_frames=3, test_frame_every=0)
    px = 40 * 48
    assert ds.all_fwd_flow.shape == (3 * px, 2) and np.isfinite(ds.all_fwd_flow).all()
    assert not ds.all_fwd_mask[2 * px:].any() and not ds.all_bwd_mask[2 * px:].any()
    assert not ds.all_fwd_flow[2 * px:].any()


def test_run_flow_asks_for_the_card_by_default(tmp_path):
    """--device defaults to cuda: without a card it raises, nothing runs on
    the CPU in its place."""
    from localrf_tpu_torch.preprocess import run_flow as trun

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    ckpt = str(tmp_path / "raft.pth")
    torch.save(traft.RAFT().state_dict(), ckpt)
    _images(str(tmp_path / "s"), 2, 16, 16, seed=0)
    with pytest.raises((RuntimeError, AssertionError)):
        trun.main(["--data_dir", str(tmp_path / "s"), "--ckpt", ckpt, "--iters", "1"])
    assert not (tmp_path / "s" / "flow_ds").exists()


# ----------------------------- DPT -----------------------------


def _narrow_hf_dpt():
    """A narrow Hugging Face DPT (hidden 64, 4 layers, 4 heads, image_size
    64, hooks 0-3) with every parameter drawn from a numpy seed."""
    transformers = pytest.importorskip("transformers")
    hfc = transformers.DPTConfig(
        hidden_size=64, num_hidden_layers=4, num_attention_heads=4, intermediate_size=128, image_size=64,
        backbone_out_indices=[0, 1, 2, 3], neck_hidden_sizes=[16, 32, 64, 64], fusion_hidden_size=32)
    hf = transformers.DPTForDepthEstimation(hfc).eval()
    rng = np.random.default_rng(12)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if p.ndim > 1:
                v = rng.normal(0, 1 / np.sqrt(p[0].numel()), p.shape)
            elif "layernorm" in name and name.endswith("weight"):
                v = rng.uniform(0.5, 1.5, p.shape)
            else:
                v = rng.normal(0, 0.1, p.shape)
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return hf


@pytest.mark.parametrize("size", [(6, 6), (30, 40)])
def test_half_pixel_resize_matches_jax_image_resize(size):
    """jax.image.resize(..., "bilinear") antialiases when it shrinks: DPT's
    F.interpolate(antialias=True) equals it within 1e-5 shrinking 24x24 to
    6x6 and growing it to 30x40, while without antialias the shrink is off
    by more than 0.1 (on N(0, 1) values)."""
    import torch.nn.functional as F

    x = np.random.default_rng(16).normal(size=(1, 24, 24, 4)).astype(np.float32)
    ref = np.asarray(jax.image.resize(x, (1, *size, 4), method="bilinear"))
    for antialias in (True, False):
        got = F.interpolate(_nchw(x), size=size, mode="bilinear", align_corners=False, antialias=antialias)
        err = np.abs(got.permute(0, 2, 3, 1).numpy() - ref).max()
        if antialias or size[0] > 24:
            assert err < 1e-5
        else:
            assert err > 0.1


@pytest.fixture(scope="module")
def dpt_trio():
    """(HF model, JAX params and config, the port's DPT) with one set of
    weights: JAX's through convert_dpt_state_dict, the port's through
    dpt_from_jax of JAX's tree."""
    import dataclasses

    from localrf_tpu.preprocess.dpt import DPTConfigJ, convert_dpt_state_dict
    from localrf_tpu_torch.convert import dpt_from_jax
    from localrf_tpu_torch.preprocess.dpt import DPT, DPTConfig

    hf = _narrow_hf_dpt()
    cfg = DPTConfig.from_hf(hf.config)
    jcfg = DPTConfigJ(**dataclasses.asdict(cfg))
    params = convert_dpt_state_dict(hf.state_dict(), jcfg)
    model = DPT(cfg)
    model.load_state_dict(dpt_from_jax(params, cfg), strict=True)
    return hf, (jax.tree.map(jnp.asarray, params), jcfg), model


def test_dpt_from_jax_inverts_convert_dpt_state_dict(dpt_trio):
    """dpt_from_jax(convert_dpt_state_dict(sd)) is the HF state dict key for
    key, equal, except the unused final layer norm (JAX drops it)."""
    hf, _, model = dpt_trio
    want, got = hf.state_dict(), model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        if not k.startswith("dpt.layernorm."):
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("size", [64, 96])
def test_dpt_matches_jax_and_transformers(dpt_trio, size):
    """At image_size (64) and above it (96, the position grid grown): the
    port, JAX's dpt_apply and HF's DPTForDepthEstimation agree within 1e-4
    of the depth's maximum."""
    hf, (params, jcfg), model = dpt_trio
    from localrf_tpu.preprocess.dpt import dpt_apply

    x = np.random.default_rng(13).normal(size=(1, size, size, 3)).astype(np.float32)
    ref = np.asarray(dpt_apply(params, jnp.asarray(x), jcfg))
    got = model(_nchw(x)).numpy()
    with torch.no_grad():
        theirs = hf(_nchw(x)).predicted_depth.numpy()
    assert got.shape == ref.shape == theirs.shape == (1, size, size)
    assert _rel_err(got, ref) < 1e-4 and _rel_err(theirs, ref) < 1e-4


def test_dpt_below_image_size_follows_jax_not_transformers(dpt_trio):
    """At 32x32 (below image_size 64) the position grid shrinks 4x4 -> 2x2:
    JAX's jax.image.resize antialiases, HF's interpolate does not. The port
    equals JAX within 1e-4 of the depth's maximum, and HF is off by more
    than 1e-3 of it."""
    hf, (params, jcfg), model = dpt_trio
    from localrf_tpu.preprocess.dpt import dpt_apply

    x = np.random.default_rng(14).normal(size=(1, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(dpt_apply(params, jnp.asarray(x), jcfg))
    got = model(_nchw(x)).numpy()
    with torch.no_grad():
        theirs = hf(_nchw(x)).predicted_depth.numpy()
    assert _rel_err(got, ref) < 1e-4
    assert _rel_err(theirs, ref) > 1e-3


def test_run_depth_matches_jax(tmp_path, dpt_trio):
    """run_depth's default backend on a model written with save_pretrained
    (read through transformers) at --size 64, against JAX's run_depth on
    the same directory: every uint16 PNG within 2 of JAX's, and at most 1%
    of a frame's pixels apart at all."""
    import cv2

    from localrf_tpu.preprocess import run_depth as jrun
    from localrf_tpu_torch.preprocess import run_depth as trun

    hf, _, _ = dpt_trio
    model_dir = str(tmp_path / "dpt")
    hf.save_pretrained(model_dir)
    jscene, tscene = str(tmp_path / "jax"), str(tmp_path / "port")
    _images(jscene, 2, 40, 48, seed=15)
    shutil.copytree(jscene, tscene)
    jrun.main(["--data_dir", jscene, "--model_dir", model_dir, "--size", "64"])
    trun.main(["--data_dir", tscene, "--model_dir", model_dir, "--size", "64", "--device", "cpu"])
    names = sorted(os.listdir(os.path.join(jscene, "depth")))
    assert names == ["000000.png", "000001.png"] == sorted(os.listdir(os.path.join(tscene, "depth")))
    for n in names:
        want = cv2.imread(os.path.join(jscene, "depth", n), cv2.IMREAD_UNCHANGED).astype(np.int64)
        got = cv2.imread(os.path.join(tscene, "depth", n), cv2.IMREAD_UNCHANGED).astype(np.int64)
        assert got.dtype == want.dtype and got.shape == want.shape == (40, 48)
        assert np.abs(got - want).max() <= 2 and (got != want).mean() <= 0.01, n

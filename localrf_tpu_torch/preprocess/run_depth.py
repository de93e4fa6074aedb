"""Monocular depth preprocessing CLI: DPT inverse depth -> depth/*.png (the
port of localrf_tpu/preprocess/run_depth.py; ref:
scripts/preprocess_all.sh:12).

Backends, each on `--device` (default cuda):
  * `dpt` (default): the port's DPT (preprocess/dpt.py) with the weights
    of a local Hugging Face snapshot (`--model_dir`, e.g. an Intel/dpt-large
    snapshot in weights/dpt-large), each image resized to `--size`^2;
  * `transformers`: Hugging Face's DPTForDepthEstimation and its image
    processor from the same directory;
  * `torchscript`: a scripted module (`--script_path`) taking [1, 3, H, W]
    in [0, 1] and returning inverse depth.

Writes uint16 PNG inverse depth in the reference's `depth/` format, scaled
to each image's maximum.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def _save_invdepth(path, invdepth):
    import cv2

    inv = np.asarray(invdepth, np.float32)
    inv = np.clip(inv, 0, None)
    scale = 65535.0 / max(float(inv.max()), 1e-6)
    cv2.imwrite(path, (inv * scale).astype(np.uint16))


def dpt_infer(model, size: int):
    """The default backend: an RGB uint8 [H, W, 3] image -> inverse depth
    [H, W] from `model` (preprocess/dpt.py::DPT) on its device."""
    import cv2

    dev = next(model.parameters()).device

    def infer(img):
        x = cv2.resize(img, (size, size), interpolation=cv2.INTER_CUBIC)
        x = (x.astype(np.float32) / 255.0 - 0.5) / 0.5
        out = model(torch.from_numpy(x).permute(2, 0, 1)[None].to(dev))[0].cpu().numpy()
        return cv2.resize(out, (img.shape[1], img.shape[0]), interpolation=cv2.INTER_CUBIC)

    return infer


def write_depths(data_dir: str, infer) -> None:
    """depth/<name>.png for every image of data_dir/images/."""
    import cv2

    img_dir = os.path.join(data_dir, "images")
    out_dir = os.path.join(data_dir, "depth")
    os.makedirs(out_dir, exist_ok=True)
    names = sorted(os.listdir(img_dir))
    for i, name in enumerate(names):
        img = cv2.imread(os.path.join(img_dir, name))[..., ::-1]
        _save_invdepth(os.path.join(out_dir, f"{os.path.splitext(name)[0]}.png"), infer(img))
        if i % 20 == 0:
            print(f"depth {i}/{len(names)}")


def main(argv=None):
    import cv2

    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--backend", default="dpt", choices=["dpt", "transformers", "torchscript"])
    parser.add_argument("--model_dir", default="weights/dpt-large",
                        help="local HF model dir (e.g. Intel/dpt-large snapshot)")
    parser.add_argument("--script_path", default="weights/dpt_scripted.pt")
    parser.add_argument("--size", type=int, default=384)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)

    if args.backend == "dpt":
        from .dpt import load_dpt_checkpoint

        infer = dpt_infer(load_dpt_checkpoint(args.model_dir, device=dev), args.size)

    elif args.backend == "transformers":
        from transformers import DPTForDepthEstimation, DPTImageProcessor

        processor = DPTImageProcessor.from_pretrained(args.model_dir)
        model = DPTForDepthEstimation.from_pretrained(args.model_dir).eval().to(dev)

        @torch.no_grad()
        def infer(img):
            inputs = processor(images=img, return_tensors="pt").to(dev)
            out = model(**inputs).predicted_depth[0].cpu().numpy()
            return cv2.resize(out, (img.shape[1], img.shape[0]), interpolation=cv2.INTER_CUBIC)

    else:
        model = torch.jit.load(args.script_path, map_location=dev).eval()

        @torch.no_grad()
        def infer(img):
            x = torch.from_numpy(img.astype(np.float32) / 255).permute(2, 0, 1)[None].to(dev)
            out = model(x)[0, 0].cpu().numpy()
            return cv2.resize(out, (img.shape[1], img.shape[0]), interpolation=cv2.INTER_CUBIC)

    write_depths(args.data_dir, infer)


if __name__ == "__main__":
    main()

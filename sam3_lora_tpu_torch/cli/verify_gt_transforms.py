"""Render ground-truth boxes and masks after the transform pipeline for
visual inspection (port of ``scripts/verify_gt_transforms.py``): loads N
samples through the pipeline the trainer uses (``train_transforms`` with
flips and colour jitter under ``--augment``), and writes overlay images so a
human can confirm that boxes still frame their masks after resize, flip and
crop. The lines printed are the script's.

The samples' images are uint8 CHW (the model normalizes on the device), and
are drawn as they are; a float pipeline's normalized image is mapped back
to uint8 first. (The script maps every image back as if normalized, which
turns a uint8 one white.)

Usage:
    python -m sam3_lora_tpu_torch.cli.verify_gt_transforms --data_dir data --out gtviz \
        [--augment] [--num 8] [--tiny]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--out", required=True)
    p.add_argument("--num", type=int, default=8)
    p.add_argument("--augment", action="store_true")
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)

    import numpy as np
    from PIL import Image

    from ..config import ModelConfig, tiny_model_config
    from ..train.data import IMAGE_MEAN, IMAGE_STD, COCOSegmentDataset
    from ..train.transforms import train_transforms
    from ..viz import draw_boxes, overlay_masks

    cfg = tiny_model_config() if args.tiny else ModelConfig()
    tf = train_transforms(cfg.img_size, hflip=True, color_jitter=True) if args.augment else None
    ds = COCOSegmentDataset(args.data_dir, args.split, model_config=cfg, transforms=tf)
    os.makedirs(args.out, exist_ok=True)

    r = cfg.img_size
    for i in range(min(args.num, len(ds))):
        s = ds.load(i, epoch=0)
        img = s.image.transpose(1, 2, 0)
        if img.dtype != np.uint8:
            img = (np.clip(img * IMAGE_STD + IMAGE_MEAN, 0, 1) * 255).astype(np.uint8)
        boxes = []
        for b, v in zip(s.boxes, s.valid):
            if not v:
                continue
            cx, cy, w, h = b
            boxes.append([(cx - w / 2) * r, (cy - h / 2) * r, (cx + w / 2) * r, (cy + h / 2) * r])
        masks = [m > 0.5 for m, mv in zip(s.masks, s.mask_valid) if mv]
        out = overlay_masks(img, masks)
        out = draw_boxes(out, boxes, labels=[s.text] * len(boxes))
        path = os.path.join(args.out, f"gt_{i:03d}.png")
        Image.fromarray(out).save(path)
        print(f"{path}: {len(boxes)} boxes, {len(masks)} masks, text={s.text!r}")
    print(f"wrote {min(args.num, len(ds))} overlays to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

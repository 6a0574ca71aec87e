"""LoRA-against-base comparison sweep (port of ``sam3_lora_tpu.cli.compare``):
N validation images through one resident model twice, with the adapters
as built (zero ``lora_b``: the frozen base's forward) and with the trained
adapters swapped in, and a per-image and a combined figure. The frozen base
is loaded once; a swap copies only the adapter tensors.

``python -m sam3_lora_tpu_torch.cli.compare --config cfg.yaml --weights
best.npz --val_data_dir data/valid --num-images 5 [--device cuda]``

Needs PyYAML for the config, PIL to read the images and matplotlib for the
figures.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import torch


def adapter_tensors(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of every adapter tensor (``lora_a``, ``lora_b``) by name."""
    from ..models.lora import LORA_LEAF_NAMES

    return {name: p.detach().clone() for name, p in model.named_parameters()
            if name.endswith(LORA_LEAF_NAMES)}


@torch.no_grad()
def set_adapters(model: torch.nn.Module, adapters: Dict[str, torch.Tensor]) -> None:
    """Copy ``adapters`` (from ``adapter_tensors``) back into the model."""
    params = dict(model.named_parameters())
    for name, t in adapters.items():
        params[name].copy_(t)


def main(argv=None):
    parser = argparse.ArgumentParser(description="LoRA vs base comparison sweep (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--weights", type=str, required=True)
    parser.add_argument("--val_data_dir", type=str, required=True)
    parser.add_argument("--num-images", type=int, default=5)
    parser.add_argument("--threshold", type=float, default=0.3)
    parser.add_argument("--output-dir", type=str, default="comparison_output")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import numpy as np

    from ..config import LoRAConfig, load_yaml_config
    from ..inference import SAM3LoRAInference
    from ..train.data import COCOSegmentDataset
    from .train import model_config_from_yaml

    cfg = load_yaml_config(args.config)
    msec = cfg.get("model", {}) or {}
    mcfg = model_config_from_yaml(msec)
    lcfg = LoRAConfig.from_dict(cfg.get("lora", {}))

    engine = SAM3LoRAInference(
        model_cfg=mcfg, lora_cfg=lcfg, base_checkpoint=msec.get("base_checkpoint"),
        threshold=args.threshold, device=args.device,
    )
    # the adapters as built (zero lora_b: the base's forward), then the trained set
    base_adapters = adapter_tensors(engine.model)

    data_dir, split = os.path.split(os.path.normpath(args.val_data_dir))
    ds = COCOSegmentDataset(data_dir, split, model_config=mcfg)
    os.makedirs(args.output_dir, exist_ok=True)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image as PILImage

    n = min(args.num_images, len(ds))
    for idx in range(n):
        sample = ds.load(idx)
        info = ds.images[ds.image_ids[idx]]
        pil = PILImage.open(str(ds.split_dir / info["file_name"])).convert("RGB")

        set_adapters(engine.model, base_adapters)
        base_res = engine.predict(pil, [sample.text])[0]
        engine.load_adapters(args.weights)
        lora_res = engine.predict(pil, [sample.text])[0]

        fig, axes = plt.subplots(1, 3, figsize=(15, 5))
        axes[0].imshow(pil)
        axes[0].set_title(f"input  ('{sample.text}')")
        for ax, res, title in ((axes[1], base_res, "base"), (axes[2], lora_res, "LoRA")):
            ax.imshow(pil)
            ax.set_title(f"{title}: {res['num_detections']} dets")
            for i in range(res["num_detections"]):
                m = res["masks"][i]
                overlay = np.zeros((*m.shape, 4))
                overlay[m] = (1.0, 0.2, 0.2, 0.45)
                ax.imshow(overlay)
        for ax in axes:
            ax.axis("off")
        out_path = os.path.join(args.output_dir, f"comparison_{idx:03d}.png")
        fig.savefig(out_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        print(f"[{idx + 1}/{n}] '{sample.text}': base {base_res['num_detections']} "
              f"vs lora {lora_res['num_detections']} dets -> {out_path}")

    # combined grid
    fig, axes = plt.subplots(n, 1, figsize=(15, 5 * n))
    if n == 1:
        axes = [axes]
    for idx, ax in enumerate(axes):
        ax.imshow(PILImage.open(os.path.join(args.output_dir, f"comparison_{idx:03d}.png")))
        ax.axis("off")
    combined = os.path.join(args.output_dir, "combined_comparison_all.png")
    fig.savefig(combined, bbox_inches="tight", dpi=100)
    plt.close(fig)
    print(f"combined grid -> {combined}")


if __name__ == "__main__":
    main()

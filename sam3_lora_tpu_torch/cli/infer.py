"""Inference CLI — ``python -m sam3_lora_tpu_torch.cli.infer --config <yaml>
--image x.jpg --prompt crack [--device cuda]`` (the flags of
``sam3_lora_tpu.cli.infer``, and ``--device``). The YAML's ``model:``
section takes ``tiny``, ``dtype``, ``base_checkpoint``, ``base_quant`` and
``base_quant_min_dim``. Needs PyYAML for the config, PIL to read the image
and matplotlib to save the overlay."""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="SAM3 + LoRA Inference (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, required=True, help="Training config YAML")
    parser.add_argument(
        "--weights", type=str, default=None,
        help="LoRA weights .npz (auto-detected from output_dir if omitted)",
    )
    parser.add_argument("--image", type=str, required=True, help="Input image")
    parser.add_argument(
        "--prompt", type=str, nargs="+", default=["object"], help="Text prompt(s)"
    )
    parser.add_argument("--output", type=str, default="output.png")
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--no-boxes", action="store_true")
    parser.add_argument("--no-masks", action="store_true")
    parser.add_argument(
        "--no-lora", action="store_true", help="Run the base model without adapters"
    )
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ..config import LoRAConfig, TrainConfig, load_yaml_config
    from ..inference import SAM3LoRAInference
    from .train import model_config_from_yaml

    cfg = load_yaml_config(args.config)
    lcfg = None if args.no_lora else LoRAConfig.from_dict(cfg.get("lora", {}))
    tcfg = TrainConfig.from_yaml_dict(cfg)
    msec = cfg.get("model", {}) or {}
    mcfg = model_config_from_yaml(msec)

    weights = args.weights
    if weights is None and not args.no_lora:
        for name in ("best_lora.npz", "last_lora.npz"):
            cand = os.path.join(tcfg.output_dir, name)
            if os.path.exists(cand):
                weights = cand
                break
        if weights is None:
            raise FileNotFoundError(
                f"no LoRA weights found in {tcfg.output_dir}; pass --weights"
            )
        print(f"auto-detected weights: {weights}")

    engine = SAM3LoRAInference(
        model_cfg=mcfg,
        lora_cfg=lcfg,
        weights=weights,
        base_checkpoint=msec.get("base_checkpoint"),
        threshold=args.threshold,
        device=args.device,
    )
    results = engine.predict(args.image, args.prompt)
    for res in results.values():
        n = res["num_detections"]
        if n:
            print(f"  '{res['prompt']}': {n} detections "
                  f"(max score: {float(res['scores'].max()):.3f})")
        else:
            print(f"  '{res['prompt']}': 0 detections")
    engine.visualize(
        args.image, results, args.output,
        show_boxes=not args.no_boxes, show_masks=not args.no_masks,
    )
    print(f"saved visualization: {args.output}")


if __name__ == "__main__":
    main()

"""Train CLI — ``python -m sam3_lora_tpu_torch.cli.train --config x.yaml
[--num-epochs N] [--device cuda]``, with the YAML surface of
``sam3_lora_tpu.cli.train``: ``model:`` (``tiny``, ``dtype``,
``base_checkpoint``), ``lora:``, ``training:`` and ``output:``. PyYAML reads
the config and PIL decodes the dataset's images; nothing else needs them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys


def setup_logging(output_dir: str) -> logging.Logger:
    """Log to stdout and to ``<output_dir>/train.log``."""
    logger = logging.getLogger("sam3_lora_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S")
    os.makedirs(output_dir, exist_ok=True)
    for handler in (logging.StreamHandler(sys.stdout),
                    logging.FileHandler(os.path.join(output_dir, "train.log"))):
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    logger.propagate = False
    return logger


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train SAM3 with LoRA (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, default="configs/full_lora_config.yaml",
                        help="Path to YAML configuration file")
    parser.add_argument("--num-epochs", type=int, default=None,
                        help="Override training.num_epochs")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda or cpu (default: cuda when available)")
    args = parser.parse_args(argv)

    from ..config import LoRAConfig, ModelConfig, TrainConfig, load_yaml_config, tiny_model_config
    from ..train.data import COCOSegmentDataset, DataLoader
    from ..train.trainer import Trainer

    cfg = load_yaml_config(args.config)
    lcfg = LoRAConfig.from_dict(cfg.get("lora", {}))
    tcfg = TrainConfig.from_yaml_dict(cfg)
    if args.num_epochs is not None:
        tcfg = dataclasses.replace(tcfg, num_epochs=args.num_epochs)
    msec = cfg.get("model", {}) or {}
    mcfg = (tiny_model_config() if msec.get("tiny")
            else ModelConfig(dtype=str(msec.get("dtype", "bfloat16"))))

    log = setup_logging(tcfg.output_dir)
    log.info("config: %s", args.config)
    log.info("lora: rank=%d alpha=%s targets=%s", lcfg.rank, lcfg.alpha, lcfg.target_modules)

    trainer = Trainer(model_cfg=mcfg, lora_cfg=lcfg, train_cfg=tcfg,
                      base_checkpoint=msec.get("base_checkpoint"), device=args.device)
    train_ds = COCOSegmentDataset(
        tcfg.data_dir, "train", model_config=mcfg,
        per_category_queries=tcfg.per_category_queries,
        include_negatives=tcfg.include_negatives,
    )
    try:
        val_ds = COCOSegmentDataset(tcfg.data_dir, "valid", model_config=mcfg)
        val_loader = DataLoader(val_ds, tcfg.batch_size, shuffle=False,
                                num_workers=tcfg.num_workers)
    except FileNotFoundError:
        log.warning("no valid split found; training without validation")
        val_loader = None
    train_loader = DataLoader(train_ds, tcfg.batch_size, num_workers=tcfg.num_workers,
                              seed=tcfg.seed)
    result = trainer.fit(train_loader, val_loader)
    log.info("done: best_val=%.4f steps=%d", result["best_val_loss"], result["steps"])
    with open(os.path.join(tcfg.output_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()

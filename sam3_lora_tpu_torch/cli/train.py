"""Train CLI — ``python -m sam3_lora_tpu_torch.cli.train --config x.yaml
[--num-epochs N] [--device cuda]``, with the YAML surface of
``sam3_lora_tpu.cli.train``: ``model:`` (``tiny``, ``dtype``,
``base_checkpoint``, and here also ``base_quant`` and
``base_quant_min_dim``), ``lora:``, ``training:`` and ``output:``. PyYAML
reads the config and PIL decodes the dataset's images; nothing else needs
them.

On N cards, one process each: ``python -m torch.distributed.run
--nproc_per_node N -m sam3_lora_tpu_torch.cli.train --config x.yaml``. Each
rank trains on its shard of every epoch (``training.batch_size`` is the
batch of one rank) on its own card, and rank 0 writes the outputs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def model_config_from_yaml(msec: dict):
    """The YAML's ``model:`` section -> ModelConfig: ``tiny: true`` starts
    from ``tiny_model_config()``, else the full model in ``dtype`` (default
    bfloat16); ``base_quant`` and ``base_quant_min_dim`` set the int8 tier."""
    from ..config import ModelConfig, tiny_model_config

    quant = {k: msec[k] for k in ("base_quant", "base_quant_min_dim") if k in msec}
    if msec.get("tiny"):
        return tiny_model_config(**quant)
    return ModelConfig(dtype=str(msec.get("dtype", "bfloat16")), **quant)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train SAM3 with LoRA (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, default="configs/full_lora_config.yaml",
                        help="Path to YAML configuration file")
    parser.add_argument("--num-epochs", type=int, default=None,
                        help="Override training.num_epochs")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ..parallel import multihost

    # join the process group before any device use (a no-op for one
    # process); gloo when the ranks train on the CPU
    multihost.initialize(backend="gloo" if args.device == "cpu" else None)
    try:
        return train(args)
    finally:
        multihost.shutdown()


def train(args):
    from ..config import LoRAConfig, TrainConfig, load_yaml_config
    from ..parallel import multihost
    from ..train.data import COCOSegmentDataset, DataLoader
    from ..train.trainer import Trainer
    from ..utils.logging import setup_logging

    cfg = load_yaml_config(args.config)
    lcfg = LoRAConfig.from_dict(cfg.get("lora", {}))
    tcfg = TrainConfig.from_yaml_dict(cfg)
    if args.num_epochs is not None:
        tcfg = dataclasses.replace(tcfg, num_epochs=args.num_epochs)
    msec = cfg.get("model", {}) or {}
    mcfg = model_config_from_yaml(msec)
    primary = multihost.is_primary()

    log = setup_logging(tcfg.output_dir if primary else None)  # one train.log, rank 0's
    log.info("config: %s", args.config)
    log.info("lora: rank=%d alpha=%s targets=%s", lcfg.rank, lcfg.alpha, lcfg.target_modules)

    trainer = Trainer(model_cfg=mcfg, lora_cfg=lcfg, train_cfg=tcfg,
                      base_checkpoint=msec.get("base_checkpoint"),
                      device=multihost.rank_device(args.device))
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
    shard = multihost.host_shard() if multihost.process_count() > 1 else None
    train_loader = DataLoader(train_ds, tcfg.batch_size, num_workers=tcfg.num_workers,
                              seed=tcfg.seed, host_shard=shard)
    result = trainer.fit(train_loader, val_loader)
    log.info("done: best_val=%.4f steps=%d", result["best_val_loss"], result["steps"])
    if primary:
        with open(os.path.join(tcfg.output_dir, "result.json"), "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()

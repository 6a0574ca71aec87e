"""Explain expected loss magnitudes from the weight dictionary (port of
``scripts/analyze_loss.py``): a total loss of ~130 at initialization is
normal for the SAM3 weights, where each raw term is O(0.1-1) but the
production weights (bbox 5, giou 2, ce 20, presence 20, mask 200, dice 10)
and the aux decoder layers multiply it up. ``--measure`` runs one forward
of the tiny model (seeded random weights, the synthetic batch of
``models.dummy_batch``) in training mode and its losses, on the card
(``--device cpu`` for the CPU). The lines printed are the script's.

Usage:
    python -m sam3_lora_tpu_torch.cli.analyze_loss [--measure] [--device cpu]
"""

from __future__ import annotations

import argparse

# the reference's worked example uses ~0.5 unweighted per term
# (analyze_loss.py: "If each unweighted loss ~ 0.5 ... total ~ 128.5,
# which matches the observed 110-159 range")
TYPICAL_RAW = {
    "loss_bbox": 0.5,
    "loss_giou": 0.5,
    "loss_ce": 0.5,
    "loss_presence": 0.5,
    "loss_mask": 0.5,
    "loss_dice": 0.5,
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--measure", action="store_true",
                   help="run one tiny-model forward + loss on synthetic data")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu, for --measure")
    args = p.parse_args(argv)

    from ..train.losses import LossConfig

    cfg = LossConfig()
    weights = {
        "loss_bbox": cfg.weight_bbox,
        "loss_giou": cfg.weight_giou,
        "loss_ce": cfg.weight_ce,
        "loss_presence": cfg.weight_presence,
        "loss_mask": cfg.weight_mask,
        "loss_dice": cfg.weight_dice,
    }
    print(f"{'term':16s} {'raw':>7s} {'weight':>7s} {'weighted':>9s}")
    total = 0.0
    for k, raw in TYPICAL_RAW.items():
        w = weights[k]
        total += raw * w
        print(f"{k:16s} {raw:7.2f} {w:7.1f} {raw * w:9.2f}")
    print(f"{'EXPECTED TOTAL':16s} {'':7s} {'':7s} {total:9.1f}")
    print("(matches the reference's observed 110-159 at init — high weights,")
    print(" especially mask 200, NOT a bug; aux decoder layers add similar")
    print(" terms but trend identically. README.md:1224-1254)")

    if args.measure:
        import torch

        from ..config import tiny_model_config
        from ..models import build_sam3_image_model, dummy_batch, init_model
        from ..train.losses import compute_losses

        device = torch.device(args.device)
        mcfg = tiny_model_config()
        model = build_sam3_image_model(mcfg, device=device)
        init_model(model, torch.Generator(device=device).manual_seed(0))
        batch = dummy_batch(mcfg, batch_size=2, with_targets=True, device=device)
        model.train()
        model.seed_dropout(1)
        with torch.no_grad():
            out = model(batch)
            losses = compute_losses(out, batch.targets, cfg)
        print("\nmeasured (tiny model, random init, synthetic batch):")
        for k in sorted(losses):
            v = float(losses[k])
            print(f"  {k:24s} {v:10.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

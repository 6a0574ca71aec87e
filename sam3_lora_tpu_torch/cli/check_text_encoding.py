"""Verify dataset category names tokenize and encode sanely (port of
``scripts/check_text_encoding.py``): for every category in a COCO dataset,
tokenize the (lowercased) name, print its token count, flag a name the
context length truncates, and with ``--encode`` run the text encoder on the
card (``--device cpu`` for the CPU) over seeded random weights to confirm
finite embeddings. The lines printed are the script's.

Usage:
    python -m sam3_lora_tpu_torch.cli.check_text_encoding --data_dir data --split train \
        [--tiny] [--encode] [--device cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--tiny", action="store_true", help="tiny config (CPU smoke)")
    p.add_argument("--encode", action="store_true",
                   help="also run the text encoder (builds the model)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu, for --encode")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ..config import ModelConfig, tiny_model_config
    from ..models.tokenizer import get_default_tokenizer
    from ..train.data import COCOSegmentDataset

    cfg = tiny_model_config() if args.tiny else ModelConfig()
    ds = COCOSegmentDataset(args.data_dir, args.split, model_config=cfg)
    tok = get_default_tokenizer()
    names = sorted(set(ds.categories.values()))
    print(f"{len(names)} categories in {args.data_dir}/{args.split}")

    ids = np.asarray(tok([n.lower() for n in names], context_length=cfg.text_context_length))
    ok = True
    for name, row in zip(names, ids):
        n_tok = int((row != 0).sum()) - 2  # minus start/end
        trunc = bool(row[-1] != 0)
        flag = "TRUNCATED!" if trunc else "ok"
        if trunc:
            ok = False
        print(f"  {name!r:30s} -> {n_tok:2d} tokens  {flag}")

    if args.encode:
        from ..models import build_sam3_image_model, init_model

        device = torch.device(args.device)
        model = build_sam3_image_model(cfg, device=device)
        init_model(model, torch.Generator(device=device).manual_seed(0))
        with torch.inference_mode():
            _, tokens = model.backbone.language_backbone(
                torch.from_numpy(ids.astype(np.int64)).to(device))
        finite = bool(torch.isfinite(tokens).all())
        print(f"text encoder output finite: {finite}, shape {tuple(tokens.shape)}")
        ok = ok and finite

    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

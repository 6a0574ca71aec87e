"""Validation CLI (port of ``sam3_lora_tpu.cli.validate``): model
predictions -> sigmoid scores -> mask NMS -> top-100, ground truth at the
seg head's resolution, then class-agnostic COCO segm mAP and cgF1.

``python -m sam3_lora_tpu_torch.cli.validate --config <yaml> --weights <npz>
--val_data_dir <dir-with-_annotations.coco.json> [--device cuda]``

The flags and the YAML surface are the JAX CLI's (``model: {tiny, dtype,
base_checkpoint}``, ``lora:``; also ``base_quant`` and
``base_quant_min_dim``), with ``--device`` (default cuda). The per-image
work is ``validate_images``, which takes the engine and any dataset with
``len()`` and ``.load(i)``; ``main`` hands it ``COCOSegmentDataset``. Needs
PyYAML for the config and PIL to read the images.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def merge_overlapping_masks(masks, scores, iou_threshold: float):
    """Union-merge overlapping predictions (for crack-like elongated
    objects): greedily group masks by pairwise IoU > threshold, OR the
    masks in a group, keep the max score."""
    n = len(masks)
    if n == 0:
        return masks, scores
    flat = masks.reshape(n, -1).astype(np.float32)
    inter = flat @ flat.T
    area = flat.sum(1)
    union = area[:, None] + area[None, :] - inter
    iou = inter / np.maximum(union, 1e-9)
    used = np.zeros(n, bool)
    out_masks, out_scores = [], []
    order = np.argsort(-scores)
    for i in order:
        if used[i]:
            continue
        group = ~used & (iou[i] > iou_threshold)
        group[i] = True
        used |= group
        out_masks.append(masks[group].any(0))
        out_scores.append(float(scores[group].max()))
    return np.stack(out_masks), np.asarray(out_scores)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def validate_images(
    engine,
    ds,
    num_samples: Optional[int] = None,
    prob_threshold: float = 0.3,
    nms_iou: float = 0.7,
    merge: bool = False,
    merge_iou: float = 0.15,
) -> Tuple[Dict[int, List[Dict]], Dict[int, List[Dict]], Dict[str, float]]:
    """Run the first ``num_samples`` of ``ds`` (all by default) through
    ``engine`` (a ``SAM3LoRAInference``).

    Per image: one forward with the sample's text; candidates with score >=
    ``prob_threshold`` that survive mask NMS at ``nms_iou`` and are not
    empty; the top 100 by score; optionally merged. The ground truth is the
    sample's valid masks at the mask-loss resolution, which is the seg
    head's. -> (gts, dts, seconds): the evaluators' per-image dicts keyed
    by ``coco_image_id``, and the seconds spent in the forward and in the
    NMS and selection (each ending in a device sync)."""
    from ..ops.nms import nms_masks

    cfg, device = engine.cfg, engine.device
    n = len(ds) if num_samples is None else min(num_samples, len(ds))
    gts: Dict[int, List[Dict]] = {}
    dts: Dict[int, List[Dict]] = {}
    seconds = {"forward": 0.0, "nms": 0.0}
    t_start = time.perf_counter()
    for idx in range(n):
        sample = ds.load(idx)
        img_id = sample.coco_image_id
        gts[img_id] = [
            {"mask": sample.masks[i] > 0.5, "iscrowd": 0}
            for i in range(len(sample.valid))
            if sample.valid[i] and sample.mask_valid[i]
        ]
        ids = engine.tokenizer([sample.text], context_length=cfg.text_context_length)
        t0 = time.perf_counter()
        scores, _, _, masks = engine._forward(
            torch.from_numpy(np.ascontiguousarray(sample.image[None])).to(device),
            torch.from_numpy(np.asarray(ids, np.int64)).to(device))
        _sync(device)
        t1 = time.perf_counter()
        s, m = scores[0], masks[0] > 0.5  # (Q,), (Q, mr, mr) bool
        keep = (s >= prob_threshold) & nms_masks(m, s, nms_iou) & m.flatten(1).any(1)
        s_host, keep_host = s.cpu().numpy(), keep.cpu().numpy()
        order = np.argsort(-s_host[keep_host])[:100]
        sel_masks = m[keep][torch.from_numpy(order).to(device)].cpu().numpy()
        sel_scores = s_host[keep_host][order]
        seconds["forward"] += t1 - t0
        seconds["nms"] += time.perf_counter() - t1
        if merge and len(sel_masks):
            sel_masks, sel_scores = merge_overlapping_masks(sel_masks, sel_scores, merge_iou)
        dts[img_id] = [
            {"mask": sel_masks[i], "score": float(sel_scores[i])}
            for i in range(len(sel_scores))
        ]
        if (idx + 1) % 25 == 0:
            print(f"  [{idx + 1}/{n}] {time.perf_counter() - t_start:.1f}s")
    return gts, dts, seconds


def dump_predictions(dts: Dict[int, List[Dict]], out_dir: str) -> str:
    """Stream ``dts`` to ``out_dir`` as RLE records (``PredictionDumper``,
    top 100 an image); -> the merged prediction file."""
    from ..eval.writer import PredictionDumper

    dumper = PredictionDumper(out_dir, top_k=100)
    for iid, recs in dts.items():
        if recs:
            dumper.add(iid, [r["score"] for r in recs], masks=np.stack([r["mask"] for r in recs]))
    return dumper.finalize()


def score_predictions(gts, dts, num_images: int, prob_threshold: float, nms_iou: float,
                      merged: bool, tide: bool = False) -> Dict:
    """The validate CLI's result dict: mAP, mAP_50, mAP_75, the cgF1 keys,
    the settings, and with ``tide`` the TIDE error split."""
    from ..eval import evaluate_cgf1, evaluate_coco_map

    map_res = evaluate_coco_map(gts, dts, iou_type="segm")
    cgf1_res = evaluate_cgf1(gts, dts, iou_type="segm")
    results = {
        "num_images": num_images,
        "mAP": map_res["mAP"],
        "mAP_50": map_res["mAP_50"],
        "mAP_75": map_res["mAP_75"],
        **cgf1_res,
        "prob_threshold": prob_threshold,
        "nms_iou": nms_iou,
        "merged": bool(merged),
    }
    if tide:
        from ..eval.tide import tide_errors

        results.update({k: float(v) for k, v in tide_errors(gts, dts).items() if k != "mAP"})
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="SAM3 LoRA validation: segm mAP + cgF1 with SAM3 NMS (PyTorch/CUDA)"
    )
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--val_data_dir", type=str, required=True)
    parser.add_argument("--use-base-model", action="store_true")
    parser.add_argument("--num-samples", type=int, default=None)
    parser.add_argument("--prob-threshold", type=float, default=0.3)
    parser.add_argument("--nms-iou", type=float, default=0.7)
    parser.add_argument("--merge", action="store_true")
    parser.add_argument("--merge-iou", type=float, default=0.15)
    parser.add_argument("--output-json", type=str, default=None)
    parser.add_argument("--dump-preds", type=str, default=None,
                        help="also stream predictions to this dir "
                             "(PredictionDumper; re-evaluable offline)")
    parser.add_argument("--tide", action="store_true",
                        help="append TIDE error decomposition "
                             "(Loc/Dup/Bkg/Miss + oracle dAP)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if not args.use_base_model and (args.config is None or args.weights is None):
        parser.error("--config and --weights required unless --use-base-model")

    from ..config import LoRAConfig, load_yaml_config
    from ..inference import SAM3LoRAInference
    from ..train.data import COCOSegmentDataset
    from .train import model_config_from_yaml

    cfg = load_yaml_config(args.config) if args.config else {}
    msec = cfg.get("model", {}) or {}
    mcfg = model_config_from_yaml(msec)
    lcfg = None if args.use_base_model else LoRAConfig.from_dict(cfg.get("lora", {}))
    engine = SAM3LoRAInference(
        model_cfg=mcfg,
        lora_cfg=lcfg,
        weights=None if args.use_base_model else args.weights,
        base_checkpoint=msec.get("base_checkpoint"),
        device=args.device,
    )

    # dataset rooted at the parent of val_data_dir
    data_dir, split = os.path.split(os.path.normpath(args.val_data_dir))
    ds = COCOSegmentDataset(data_dir, split, model_config=mcfg)
    n_samples = len(ds) if args.num_samples is None else min(args.num_samples, len(ds))
    gts, dts, _ = validate_images(engine, ds, n_samples, args.prob_threshold, args.nms_iou,
                                  args.merge, args.merge_iou)
    if args.dump_preds:
        print(f"predictions dumped to {dump_predictions(dts, args.dump_preds)}")
    results = score_predictions(gts, dts, n_samples, args.prob_threshold, args.nms_iou,
                                args.merge, tide=args.tide)
    print(json.dumps(results, indent=2))
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()

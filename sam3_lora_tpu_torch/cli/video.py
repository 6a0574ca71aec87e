"""Video grounding CLI: text-prompted detection and tracking over a video
(port of ``sam3_lora_tpu/cli/video.py``, its flags and ``--device``).

Decode a video (mp4 or a frame directory), run the per-frame detector
(with ``--propagate``, tracker memory propagation too) and write per-frame
results as JSON lines with COCO-RLE masks. With ``--gt`` (YTVIS-style
annotations) it also prints HOTA, CLEAR-MOT and track mAP
(``eval/video_eval.py``) as one JSON line of the scalar metrics.

Usage:
    python -m sam3_lora_tpu_torch.cli.video --video clip.mp4 --prompt "person" \\
        --config cfg.yaml --weights out/best_lora.npz --output out.jsonl \\
        [--propagate] [--max-frames N] [--gt annotations.json] [--device cuda]

A video file needs OpenCV, a frame directory and ``--gt`` need PIL, the
config PyYAML.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description="SAM3 LoRA video grounding (PyTorch/CUDA)")
    p.add_argument("--video", required=True, help="mp4 / frame dir")
    p.add_argument("--prompt", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--weights", default=None, help="LoRA adapter .npz")
    p.add_argument("--output", default="video_results.jsonl")
    p.add_argument("--prob-threshold", type=float, default=0.5)
    p.add_argument("--nms-iou", type=float, default=0.7)
    p.add_argument("--num-slots", type=int, default=16)
    p.add_argument("--propagate", action="store_true",
                   help="tracker memory propagation each frame")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--gt", default=None,
                   help="YTVIS-style annotations.json for HOTA/MOTA eval")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np

    from ..config import LoRAConfig, ModelConfig, load_yaml_config, tiny_model_config
    from ..io_utils import AsyncVideoFrameLoader
    from ..ops.rle import rle_encode
    from ..processor import Sam3Processor
    from ..video_predictor import Sam3VideoPredictor

    cfg = load_yaml_config(args.config) if args.config else {}
    msec = cfg.get("model", {}) or {}
    mcfg = (
        tiny_model_config()
        if msec.get("tiny")
        else ModelConfig(dtype=str(msec.get("dtype", "bfloat16")))
    )
    lcfg = LoRAConfig.from_dict(cfg.get("lora", {})) if args.weights else None
    proc = Sam3Processor(
        model_cfg=mcfg, lora_cfg=lcfg, weights=args.weights,
        base_checkpoint=msec.get("base_checkpoint"), device=args.device,
    )
    predictor = Sam3VideoPredictor(
        proc, propagate_memory=args.propagate,
        num_slots=args.num_slots, prob_threshold=args.prob_threshold,
        nms_iou=args.nms_iou,
    )
    loader = AsyncVideoFrameLoader(args.video, max_frames=args.max_frames)
    sid = predictor.start_session(list(loader))
    predictor.add_prompt(sid, args.prompt)

    pred_tracks: dict = {}
    n = 0
    with open(args.output, "w") as f:
        for out in predictor.propagate_in_video(sid):
            recs = []
            for oid, score, mask in zip(out["obj_ids"], out["scores"], out["masks_lowres"]):
                rle = rle_encode(np.asarray(mask, np.uint8))
                recs.append({"obj_id": int(oid), "score": float(score), "segmentation": rle})
                pred_tracks.setdefault(int(oid), {})[out["frame_idx"]] = np.asarray(mask, bool)
            f.write(json.dumps({"frame_idx": out["frame_idx"], "objects": recs}) + "\n")
            n += 1
    print(f"wrote {n} frames to {args.output} ({len(pred_tracks)} tracked objects)")

    if args.gt:
        from ..eval.video_eval import evaluate_clear_mot, evaluate_hota, evaluate_track_map
        from ..ops.rle import rle_decode

        with open(args.gt) as fgt:
            gt = json.load(fgt)
        mr = pred_tracks and next(iter(pred_tracks.values()))
        gt_tracks: dict = {}
        for ann in gt["annotations"]:
            tr = {}
            for fi, seg in enumerate(ann.get("segmentations") or []):
                if seg is None or (args.max_frames and fi >= args.max_frames):
                    continue
                m = rle_decode(seg).astype(bool)
                if mr:
                    # compare at the prediction resolution
                    from PIL import Image

                    size = next(iter(mr.values())).shape
                    m = np.asarray(
                        Image.fromarray(m.astype(np.uint8)).resize(
                            (size[1], size[0]), Image.NEAREST
                        )
                    ).astype(bool)
                tr[fi] = m
            if tr:
                gt_tracks[ann["id"]] = tr
        scores = {oid: 1.0 for oid in pred_tracks}
        metrics = {}
        metrics.update(evaluate_hota(gt_tracks, pred_tracks))
        metrics.update(evaluate_clear_mot(gt_tracks, pred_tracks))
        metrics.update(evaluate_track_map(gt_tracks, pred_tracks, scores))
        # the scalar metrics: HOTA's per-alpha arrays stay out of the line
        # (the JAX CLI's round() raises on them)
        print(json.dumps({k: round(float(v), 4) for k, v in metrics.items() if np.ndim(v) == 0}))

    predictor.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Evaluators of the port: class-agnostic COCO mAP, cgF1, the TIDE error
split, the streaming prediction dumper with its offline re-evaluation, the
video tracking metrics, and the SA-Co video evaluators in ``saco_veval``
(copies of ``sam3_lora_tpu/eval``'s modules, which import no JAX)."""

from .coco_map import evaluate_coco_map
from .cgf1 import evaluate_cgf1
from .writer import PredictionDumper, evaluate_pred_file, load_predictions
from .tide import tide_errors
from .video_eval import (
    evaluate_hota,
    evaluate_clear_mot,
    evaluate_track_map,
    track_iou,
)

__all__ = [
    "evaluate_coco_map",
    "evaluate_cgf1",
    "PredictionDumper",
    "evaluate_pred_file",
    "load_predictions",
    "evaluate_hota",
    "evaluate_clear_mot",
    "evaluate_track_map",
    "track_iou",
    "tide_errors",
]

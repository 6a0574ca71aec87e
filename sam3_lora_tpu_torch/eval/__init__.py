"""Image evaluators of the port: class-agnostic COCO mAP, cgF1, the TIDE
error split, and the streaming prediction dumper with its offline
re-evaluation (copies of ``sam3_lora_tpu/eval``'s image evaluators)."""

from .coco_map import evaluate_coco_map
from .cgf1 import evaluate_cgf1
from .writer import PredictionDumper, evaluate_pred_file, load_predictions
from .tide import tide_errors

__all__ = [
    "evaluate_coco_map",
    "evaluate_cgf1",
    "PredictionDumper",
    "evaluate_pred_file",
    "load_predictions",
    "tide_errors",
]

from .logging import (
    AverageMeter,
    DurationMeter,
    MemMeter,
    ProgressMeter,
    TensorBoardLogger,
    capture_trace,
    setup_logging,
    trace_span,
)

__all__ = [
    "setup_logging",
    "AverageMeter",
    "DurationMeter",
    "MemMeter",
    "ProgressMeter",
    "TensorBoardLogger",
    "trace_span",
    "capture_trace",
]

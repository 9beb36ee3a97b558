from boxfusion_tpu_torch.eval.ap3d import (
    average_precision_3d,
    average_precision_3d_per_class,
    match_detections,
)
from boxfusion_tpu_torch.eval.runner import evaluate_sequences, evaluate_sequences_batched

__all__ = [
    "average_precision_3d",
    "average_precision_3d_per_class",
    "match_detections",
    "evaluate_sequences",
    "evaluate_sequences_batched",
]

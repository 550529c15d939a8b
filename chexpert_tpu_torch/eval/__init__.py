"""Evaluation: metrics (ROC, AUC, precision-recall, mean loss) and the
N-checkpoint ensemble."""

from chexpert_tpu_torch.eval.ensemble import evaluate_ensemble, list_checkpoints
from chexpert_tpu_torch.eval.metrics import (
    auc,
    avg_auc,
    compute_metrics,
    precision_recall_curve,
    roc_curve,
    sum_loss,
)

__all__ = ["auc", "avg_auc", "compute_metrics", "evaluate_ensemble", "list_checkpoints",
           "precision_recall_curve", "roc_curve", "sum_loss"]

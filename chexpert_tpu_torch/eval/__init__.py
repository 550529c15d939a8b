from chexpert_tpu_torch.eval.metrics import (
    auc,
    avg_auc,
    compute_metrics,
    precision_recall_curve,
    roc_curve,
    sum_loss,
)

__all__ = ["auc", "avg_auc", "compute_metrics", "precision_recall_curve", "roc_curve",
           "sum_loss"]

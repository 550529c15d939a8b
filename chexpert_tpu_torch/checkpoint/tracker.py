"""Best-K checkpoint tracker: the port's copy of
chexpert_tpu/checkpoint/tracker.py, the reference's save_checkpoint
bookkeeping (chexpert.py:90-123), with ``.pt`` checkpoint files:

  * checkpoints_tracker.csv, space-delimited, header
    'CheckpointId Step Loss AvgAUC' (numpy savetxt '#'-prefixed)
  * keeps max_records rows sorted descending by AvgAUC
  * at capacity: the lowest-AUC record is evicted and its file id REUSED for
    the incoming checkpoint
  * the tracker + best checkpoint are only written when the incoming avg_auc
    beats the evicted record's (or unconditionally below capacity —
    lowest_auc inits to -inf, chexpert.py:105)
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

TRACKER_HEADER = " ".join(["CheckpointId", "Step", "Loss", "AvgAUC"])


def update_tracker(
    output_dir: str,
    step: int,
    eval_loss: float,
    avg_auc: float,
    save_best: Callable[[str], None],
    max_records: int = 10,
) -> Optional[str]:
    """Run the tracker protocol; call save_best(path) if this checkpoint
    belongs in the best set. Returns the saved path or None."""
    tracker_path = os.path.join(output_dir, "checkpoints_tracker.csv")

    old_data = None
    file_id = 0
    lowest_auc = float("-inf")
    if os.path.exists(tracker_path):
        old_data = np.atleast_2d(np.loadtxt(tracker_path, skiprows=1))
        file_id = len(old_data)
        if len(old_data) == max_records:
            lowest_auc_idx = old_data[:, 3].argmin()
            lowest_auc = old_data[lowest_auc_idx, 3]
            file_id = int(old_data[lowest_auc_idx, 0])
            old_data = np.delete(old_data, lowest_auc_idx, 0)

    data = np.atleast_2d([file_id, step, eval_loss, avg_auc])
    if old_data is not None:
        data = np.vstack([old_data, data])
    data = data[data.argsort(0)[:, 3][::-1]]  # sort descending by AvgAUC

    if avg_auc > lowest_auc:
        np.savetxt(tracker_path, data, delimiter=" ", header=TRACKER_HEADER)
        path = os.path.join(output_dir, "best_checkpoints", f"checkpoint_{file_id}.pt")
        save_best(path)
        return path
    return None

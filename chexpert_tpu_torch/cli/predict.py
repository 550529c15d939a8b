"""Competition predict CLI of the PyTorch port: a csv of image paths in, per-
study probabilities out (counterpart of chexpert_tpu/cli/predict.py, with
its flags plus ``--device``):

    python -m chexpert_tpu_torch.cli.predict data.csv out.csv \\
        --restore_path CKPT_OR_DIR --model aadensenet121 [--device cuda]

  * a checkpoint file, or a directory of checkpoint*.pt whose predictions
    are averaged (reference predict.py:63, 87);
  * sigmoid probabilities, grouped by study (the Path up to its last '/'),
    the max over a study's views (predict.py:48-51), then for a directory
    the mean over the checkpoints;
  * the csv as pandas writes the JAX CLI's: header ``Study,<5 labels>``,
    the studies in sorted order (pandas' groupby sorts), floats as
    ``data.chexpert.format_float`` writes them;
  * ``--debug`` scores the predictions against the valid set under
    ``--valid_data_path`` (or ``$CHEXPERT_TPU_DATA_DIR``), joining studies
    on their last two path components (patient/study), as the JAX CLI does.

The reference's undefined-variable bug at predict.py:42 (``idxs`` for
``idx``) is fixed as the JAX CLI fixes it. The run goes on ``--device``
(default ``cuda``; the CPU runs only when asked). One process drives one
device: ``--data_parallel`` 0 or 1 runs on it, and a larger value raises the
JAX ``create_mesh`` assertion ("mesh 2x1 needs 2 devices, have 1"). To
predict on N cards, run one process per card on its part of the csv.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import numpy as np
import torch

from chexpert_tpu_torch.checkpoint import load_model_checkpoint
from chexpert_tpu_torch.data import ATTR_NAMES, Batches, ChexpertIndex, device_prefetch
from chexpert_tpu_torch.data import extract_patient_ids
from chexpert_tpu_torch.data.chexpert import format_float, write_csv
from chexpert_tpu_torch.eval import compute_metrics, list_checkpoints
from chexpert_tpu_torch.models import build_model, normalize_state_dict
from chexpert_tpu_torch.parallel import create_mesh
from chexpert_tpu_torch.train import eval_logits, prepare_image
from chexpert_tpu_torch.utils import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("data_path", type=str, help="Path to input data csv file.")
    p.add_argument("output_path", type=str, help="Path for output csv file.")
    p.add_argument("--restore_path", type=str, required=True,
                   help="Checkpoint file, or folder of checkpoints to ensemble.")
    p.add_argument("--model", default="densenet121")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--resize", type=int, default=None)
    p.add_argument("--image_size", type=int, default=320)
    p.add_argument("--mini_data", type=int, default=None)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--data_parallel", type=int, default=0)
    p.add_argument("--data_workers", type=int, default=8)
    p.add_argument("--debug", action="store_true",
                   help="Evaluate prediction output against the valid dataset.")
    p.add_argument("--valid_data_path", default="",
                   help="Dataset root holding the valid set for --debug "
                        "(falls back to $CHEXPERT_TPU_DATA_DIR).")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' on request)")
    return p


def group_max(study_ids, values: np.ndarray) -> Tuple[List[str], np.ndarray]:
    """(sorted unique studies, per-study max of ``values``' rows)."""
    studies = sorted(set(study_ids))
    pos = {s: i for i, s in enumerate(studies)}
    out = np.full((len(studies), values.shape[1]), -np.inf, values.dtype)
    np.maximum.at(out, np.array([pos[s] for s in study_ids], np.int64), values)
    return studies, out


def predict(model: torch.nn.Module, batches: Batches, index: ChexpertIndex,
            device: torch.device, compute_dtype: torch.dtype) -> Tuple[List[str], np.ndarray]:
    """Sigmoid probabilities -> (sorted studies, (S, 5) f32 max over views)."""
    probs, study_ids = [], []
    for batch in device_prefetch(batches, device):
        p = torch.sigmoid(eval_logits(model, prepare_image(batch["image"]), compute_dtype))
        m = batch["mask"].cpu().numpy().astype(bool)
        probs.append(p.cpu().numpy()[m])
        study_ids += list(extract_patient_ids(index, batch["index"].cpu().numpy()[m]))
    return group_max(study_ids, np.concatenate(probs, 0))


def write_predictions(path: str, studies: List[str], probs: np.ndarray) -> None:
    write_csv(path, ["Study", *ATTR_NAMES],
              [[s, *(format_float(v) for v in row)] for s, row in zip(studies, probs)])


def _suffix(study: str) -> str:
    """The patient/study part of a study id: test csvs may carry absolute
    paths, the valid index dataset-relative ones."""
    return "/".join(str(study).split("/")[-2:])


def debug_metrics(studies: List[str], probs: np.ndarray, data_dir: str) -> dict:
    """Metrics of the predictions against the valid set's per-study targets
    (the max over views), on the studies both have (reference
    predict.py:100-116)."""
    vindex = ChexpertIndex(data_dir, "valid")
    t_studies, targets = group_max(extract_patient_ids(vindex, vindex.all_indices()),
                                   vindex.all_labels())
    pred_of = {_suffix(s): row for s, row in zip(studies, probs)}
    rows = [(pred_of[_suffix(s)], t) for s, t in zip(t_studies, targets)
            if _suffix(s) in pred_of]
    if not rows:
        raise RuntimeError(
            "--debug: no overlapping studies between predictions and the valid set — "
            "check --valid_data_path / $CHEXPERT_TPU_DATA_DIR")
    return compute_metrics(np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]),
                           np.zeros((1, len(ATTR_NAMES))))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    create_mesh(args.data_parallel, 1)  # one device: a larger mesh raises
    device = resolve_device(args.device)
    compute_dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    model = build_model(args.model, image_size=args.resize or args.image_size, device=device)
    index = ChexpertIndex(args.data_path, "test", mini_data=args.mini_data)
    batches = Batches(index, args.batch_size, image_size=args.image_size, resize=args.resize,
                      workers=args.data_workers)

    def load_and_predict(path: str) -> Tuple[List[str], np.ndarray]:
        sd = load_model_checkpoint(path)["state_dict"]
        model.load_state_dict(normalize_state_dict(sd, args.model), strict=True)
        return predict(model, batches, index, device, compute_dtype)

    if os.path.isdir(args.restore_path):
        paths = list_checkpoints(args.restore_path)
        if not paths:
            raise AssertionError("no checkpoints found to ensemble")
        print(f"Running ensemble prediction using {len(paths)} checkpoints.")
        runs = [load_and_predict(p) for p in paths]
        studies = runs[0][0]
        # mean over checkpoints per study and column (predict.py:87), summed in
        # f64 and kept in f32 as pandas keeps the JAX CLI's f32 frame: saturated
        # probabilities then tie as they do there, and the AUCs of --debug agree
        probs = np.mean(np.stack([r[1] for r in runs]).astype(np.float64),
                        axis=0).astype(np.float32)
    else:
        print(f"Running prediction using {args.restore_path}")
        studies, probs = load_and_predict(args.restore_path)
    write_predictions(args.output_path, studies, probs)

    if args.debug:
        data_dir = args.valid_data_path or os.environ.get("CHEXPERT_TPU_DATA_DIR", "")
        metrics = debug_metrics(studies, probs, data_dir)
        print("Metrics for predictions vs targets:")
        print("AUC:\n", metrics["aucs"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

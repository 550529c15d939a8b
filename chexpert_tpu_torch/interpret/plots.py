"""Matplotlib artifacts: vis grids, attention maps, ROC/PR plots (port of
chexpert_tpu/interpret/plots.py: the same file names, figure geometry,
colormaps and panel layout).

matplotlib is imported (with the Agg backend) inside these functions, never
when the module is imported: the card host need not have it, and only the
PNGs need it. Without it they raise ImportError naming it.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List, Sequence

import numpy as np

from chexpert_tpu_torch.data.chexpert import ATTR_NAMES

# output-spec constants (reference chexpert.py:329,349-351,366-370,379,400,421-426)
_GRID_FIG_SCALE = (4 / 100, 3.3 / 100)   # (width, height) per image pixel
_PROBE_WINDOW = 30                        # attention probe half-window, px
_PROBE_COLOR = (1.0, 215 / 255, 0.0)      # highlight square (yellow)
_CURVE_LIMS = (0.0, 1.05)                 # ROC/PR axis limits


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("matplotlib is needed to render the PNGs of --visualize and "
                          "--plot_roc, and it is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# --------------------------------------------------------------------------
# panel renderers
# --------------------------------------------------------------------------

def _render_table_panel(plt, ax, names, label, prob, title):
    """GT-vs-probability table, cells shaded green by value."""
    cells = np.stack([label, prob.round(3)], axis=1)
    ax.table(cellText=cells, rowLabels=names, colLabels=["Ground truth", "Pred. prob"],
             rowColours=plt.cm.Greens(0.5 * label), cellColours=plt.cm.Greens(0.5 * cells),
             cellLoc="center", loc="center")
    ax.set_title(title)
    ax.axis("tight")
    ax.axis("off")


def _render_image_panel(ax, img, title, overlay=None):
    """Grayscale image, optionally with a jet heatmap overlay."""
    ax.imshow(np.asarray(img).squeeze(), cmap="gray")
    if overlay is not None:
        ax.imshow(np.asarray(overlay).squeeze(), cmap="jet", alpha=0.5)
    ax.set_title(title, fontsize=10)
    ax.axis("off")


def _render_example_row(plt, axs, img, mask, label, prob, patient_id, attr_names):
    """One vis-grid row: [table | original | top-class CAM overlay]."""
    order = np.argsort(prob)[::-1]  # most-confident class first
    names = [attr_names[i] for i in order]
    _render_table_panel(plt, axs[0], names, label[order], prob[order], title=patient_id)
    _render_image_panel(axs[1], img, "Original image")
    cam_title = "Top class activation \n{}: {:.4f}".format(names[0], prob[order][0])
    _render_image_panel(axs[2], img, cam_title, overlay=mask)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def save_vis_grids(
    imgs: np.ndarray,          # (N, H, W, C) denormalized
    masks: np.ndarray,         # (N, 1, H, W) grad-cam
    labels: np.ndarray,        # (N, 5)
    probs: np.ndarray,         # (N, 5) sigmoid
    idxs: List[int],           # original csv row indices, order == batch order
    patient_ids: Sequence[str],
    vis_attrs: Sequence[str],
    vis_idxs: Sequence[Sequence[int]],
    output_dir: str,
    step: int,
) -> List[str]:
    """One figure per vis category, rows of [table|image|CAM]. Returns paths."""
    plt = _pyplot()
    h_px, w_px = imgs.shape[1], imgs.shape[2]
    figsize = (_GRID_FIG_SCALE[0] * h_px, _GRID_FIG_SCALE[1] * w_px)
    paths = []
    for attr, cat_idxs in zip(vis_attrs, vis_idxs):
        rows = max(len(cat_idxs), 1)
        fig, axs = plt.subplots(rows, 3, figsize=figsize, dpi=100, frameon=False,
                                squeeze=False)
        fig.suptitle(attr)
        for row_axs, row_idx in zip(axs, cat_idxs):
            k = idxs.index(row_idx)  # batch position of this csv row
            _render_example_row(plt, row_axs, imgs[k], masks[k], labels[k], probs[k],
                                patient_ids[k], ATTR_NAMES)
        for ax in axs.flat:
            ax.axis("off")
        out = os.path.join(output_dir, "vis",
                           "vis_{}_step_{}.png".format(attr.replace(" ", "_"), step))
        fig.savefig(out, dpi=100)
        plt.close(fig)
        paths.append(out)
    return paths


def _probe_points(h: int, w: int) -> List[tuple]:
    """Four probe pixels: vertices of the centered 1/3-side square."""
    return list(itertools.product((h // 3, 2 * h // 3), (w // 3, 2 * w // 3)))


def _clamped_window(arr: np.ndarray, center: tuple, half: int) -> np.ndarray:
    """Square crop of ``arr``'s two leading dims around ``center``, edge-clamped."""
    (r, c), hw = center, half
    return arr[max(r - hw, 0): r + hw, max(c - hw, 0): c + hw]


def _with_probe_highlight(img: np.ndarray, center: tuple, half: int) -> np.ndarray:
    """RGB copy of a (H, W, C) image with a solid square painted at ``center``."""
    rgb = np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img[..., :3].copy()
    patch = _clamped_window(rgb, center, half)
    patch[...] = _PROBE_COLOR
    return np.clip(rgb, 0.0, 1.0)


def save_attn_maps(
    x: np.ndarray,                  # (B, H, W, C) denormalized input images
    attn_weights: List[np.ndarray], # per layer: (B, nh, HW, HW)
    patient_ids: Sequence[str],
    idxs: Sequence[int],
    output_dir: str,
    batch_element: int = 0,
) -> List[str]:
    """Per-attention-layer probe grids: a column per probe pixel (the input
    image with the probe highlighted on top, one window-mean attention map
    per head below). Returns paths."""
    plt = _pyplot()
    img = x[batch_element]
    H, W = img.shape[:2]
    image_probes = _probe_points(H, W)
    paths = []
    for layer_i, layer_weights in enumerate(attn_weights):
        attn = np.asarray(layer_weights[batch_element])   # (nh, HW, HW)
        nh = attn.shape[0]
        side = int(np.sqrt(attn.shape[-1]))               # feature-map h == w
        # attention over keys as (head, qh, qw, kh, kw); probe windows in
        # query space at feature-map scale
        attn = attn.reshape(nh, side, side, side, side)
        feat_half = max(1, int(_PROBE_WINDOW * side / H))

        fig, axs = plt.subplots(nh + 1, 4, figsize=(3, 3 / 4 * (1 + nh)), frameon=False)
        fig.suptitle(str(patient_ids[batch_element]), fontsize=8)
        for col, (img_pt, feat_pt) in enumerate(zip(image_probes, _probe_points(side, side))):
            axs[0, col].imshow(_with_probe_highlight(img, img_pt, _PROBE_WINDOW))
            for head in range(nh):
                key_map = _clamped_window(attn[head], feat_pt, feat_half).mean((0, 1))
                axs[head + 1, col].imshow(key_map)
        for ax in axs.flat:
            ax.axis("off")
        out = os.path.join(
            output_dir, "vis",
            f"attn_image_idx_{idxs[batch_element]}_{batch_element}_layer_{layer_i}.png")
        fig.subplots_adjust(0, 0, 1, 0.95, 0.05, 0.05)
        fig.savefig(out)
        plt.close(fig)
        paths.append(out)
    return paths


def _per_class_curves(metrics: Dict, labels: Sequence[str]):
    """Yield (label, fpr, tpr, auc, precision, recall) per class, in order."""
    keys = list(metrics["fpr"].keys())
    for name, k in zip(labels, keys):
        auc = metrics["aucs"][k]
        yield (name, metrics["fpr"][k], metrics["tpr"][k],
               float("nan") if auc is None else auc,
               metrics["precision"][k], metrics["recall"][k])


def plot_roc(metrics: Dict, output_dir: str, filename: str,
             labels: Sequence[str] = tuple(ATTR_NAMES)) -> str:
    """2xN figure from a saved eval_results json: ROC per class on the top
    row (AUC legend, chance diagonal), PR per class below."""
    plt = _pyplot()
    fig, axs = plt.subplots(2, len(labels), figsize=(24, 12))
    for col, (name, fpr, tpr, auc, prec, rec) in enumerate(_per_class_curves(metrics, labels)):
        roc_ax, pr_ax = axs[0, col], axs[1, col]
        roc_ax.plot(fpr, tpr, label="AUC = %0.2f" % auc)
        roc_ax.plot([0, 1], [0, 1], "k--")
        roc_ax.set(title=name, xlabel="False Positive Rate")
        roc_ax.legend(loc="lower right")
        pr_ax.step(rec, prec, where="post")
        pr_ax.set(xlabel="Recall")
    fig.suptitle(filename)
    axs[0, 0].set_ylabel("True Positive Rate")
    axs[1, 0].set_ylabel("Precision")
    for ax in axs.flat:
        ax.set(xlim=_CURVE_LIMS, ylim=_CURVE_LIMS, aspect="equal")
    fig.tight_layout()
    path = os.path.join(output_dir, "plots", filename + ".png")
    fig.savefig(path, pad_inches=0.0)
    plt.close(fig)
    return path

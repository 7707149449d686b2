"""Matplotlib visualization of particle edge-probability matrices (the
port's copy of ``dibs_tpu/utils/visualize.py``).

matplotlib is imported inside each function, so the package imports where
it is missing. Matrices may be numpy arrays or (CPU or CUDA) tensors.
"""
from __future__ import annotations

import numpy as onp

__all__ = ["visualize", "visualize_ground_truth"]


def _host(mat) -> onp.ndarray:
    return onp.asarray(mat.detach().cpu() if hasattr(mat, "detach") else mat)


def visualize_ground_truth(mat, size=4.0):
    """Single matshow of the ground-truth adjacency matrix."""
    import matplotlib.pyplot as plt

    plt.rcParams["figure.figsize"] = [size, size]
    fig, ax = plt.subplots(1, 1)
    ax.matshow(_host(mat), vmin=0, vmax=1)
    plt.setp(ax.get_xticklabels(), visible=False)
    plt.setp(ax.get_yticklabels(), visible=False)
    ax.tick_params(axis="both", which="both", length=0)
    ax.set_title("Ground truth $G^*$", pad=10)
    plt.show()


def visualize(mats, t=None, save_path=None, n_cols=7, size=2.5, show=False):
    """Grid of particle matrices (edge probabilities in ``[0, 1]``).

    Optionally saves a PNG per call (``save_path/img{t}.png``) and returns the
    rendered frame as an image array so runs can be stitched into GIFs,
    as the reference does. Returns ``None`` when ``save_path`` is not
    given.
    """
    import matplotlib.pyplot as plt

    n_rows = len(mats) // n_cols
    if len(mats) % n_cols:
        n_rows += 1

    plt.rcParams["figure.figsize"] = [size * n_cols, size * n_rows]
    fig, axes = plt.subplots(n_rows, n_cols)
    axes = onp.atleast_2d(axes)

    for j, ax in enumerate(axes.flatten()):
        if j < len(mats):
            ax.matshow(_host(mats[j]), vmin=0, vmax=1)
            ax.set_title(r"$Z^{(" f"{j}" r")}$", pad=3)
        ax.tick_params(axis="both", which="both", length=0)
        plt.setp(ax.get_xticklabels(), visible=False)
        plt.setp(ax.get_yticklabels(), visible=False)
        ax.axis("off")

    if t is not None:
        fig.suptitle(f"iteration {t}", y=1.02)
    plt.tight_layout()
    img = None
    if save_path is not None:
        import os

        os.makedirs(save_path, exist_ok=True)
        png = os.path.join(save_path, f"img{t}.png")
        fig.savefig(png, bbox_inches="tight", dpi=100)
        try:
            import imageio.v2 as imageio

            img = imageio.imread(png)
        except ImportError:  # imageio optional: matplotlib reads PNGs too
            img = plt.imread(png)
    if show:
        plt.show()
    plt.close(fig)
    return img

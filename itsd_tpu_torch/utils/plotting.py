"""Loss and metric curves as PNG files.

Counterpart of ``itsd_tpu/utils/plotting.py``: the smoothed, downsampled
loss against the step with a box of statistics, and FID / IS / CLIP
against the denoising timestep. matplotlib is imported when a curve is
drawn. Where it is not installed, each function prints one line saying
so and writes nothing; the JSON records beside the curves hold the same
numbers.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _pyplot(path: str):
    """matplotlib's pyplot on the Agg backend, or None (with a printed
    line) when matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print(f"[plotting] matplotlib is not installed: {path} not written")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return plt


def plot_loss_curve(losses: Sequence[float], path: str,
                    smooth_window: int = 50, max_points: int = 2000
                    ) -> Optional[str]:
    """Loss against step (at most ``max_points`` shown), its moving mean
    over ``smooth_window`` steps and the final, least and mean loss.
    Returns ``path``, or None when nothing was written."""
    plt = _pyplot(path)
    if plt is None:
        return None
    losses = np.asarray(losses, dtype=np.float64)
    fig, ax = plt.subplots(figsize=(10, 5))
    steps = np.arange(len(losses))
    if len(losses) > max_points:
        stride = len(losses) // max_points
        steps, shown = steps[::stride], losses[::stride]
    else:
        shown = losses
    ax.plot(steps, shown, alpha=0.3, label="loss")
    if len(losses) >= smooth_window:
        kernel = np.ones(smooth_window) / smooth_window
        smooth = np.convolve(losses, kernel, mode="valid")
        ax.plot(np.arange(len(smooth)) + smooth_window // 2, smooth,
                label=f"smoothed (w={smooth_window})")
    stats = (f"final: {losses[-1]:.4f}\nmin: {losses.min():.4f}\n"
             f"mean: {losses.mean():.4f}")
    ax.text(0.98, 0.95, stats, transform=ax.transAxes, ha="right",
            va="top", bbox=dict(boxstyle="round", alpha=0.2))
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.legend()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_metrics_curves(history: List[Tuple[int, float, float, float]],
                        path: str, T: Optional[int] = None
                        ) -> Optional[str]:
    """FID, IS and CLIP against the denoising timestep from history rows
    ``(t, fid, is, clip)``; a NaN leaves a gap. Returns ``path``, or None
    when nothing was written."""
    plt = _pyplot(path)
    if plt is None:
        return None
    hist = np.asarray(history, dtype=np.float64)
    ts = hist[:, 0]
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for i, (ax, name) in enumerate(zip(axes, ["FID", "IS", "CLIP"])):
        ax.plot(ts, hist[:, i + 1], marker="o")
        ax.set_xlabel("denoising timestep t")
        ax.set_ylabel(name)
        ax.set_title(f"{name} during denoising")
        if T is not None:
            ax.set_xlim(T, 0)
        else:
            ax.invert_xaxis()
    fig.tight_layout()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path

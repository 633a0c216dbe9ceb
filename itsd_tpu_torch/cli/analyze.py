"""Representation analysis: the per-epoch dumps that training writes
(``save_weight_dir/representations/epoch_{e}.npz``), their statistics, a
PCA -> t-SNE scatter coloured by class and the per-epoch evolution plot.

Counterpart of ``itsd_tpu/cli/analyze.py``. It needs no card and no torch:
numpy reads the dumps. scikit-learn and matplotlib are imported when a plot
is drawn; where either is missing, the statistics still print and each plot
says in one line that it was skipped.

Usage:
    python -m itsd_tpu_torch.cli.analyze --repr-dir ckpt/representations \\
        --out-dir analysis/
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.plotting import _pyplot


def load_representations(repr_dir: str
                         ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """epoch -> (representations [N, D], labels [N]) of every
    ``epoch_*.npz`` in ``repr_dir``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(repr_dir, "epoch_*.npz"))):
        epoch = int(os.path.basename(path)[len("epoch_"):-len(".npz")])
        with np.load(path) as d:
            out[epoch] = (d["representations"], d["labels"])
    return out


def representation_stats(reps: np.ndarray, labels: np.ndarray) -> dict:
    """Count, width, mean, std, least and largest value, and the label
    histogram."""
    hist = np.bincount(labels, minlength=int(labels.max()) + 1)
    return {
        "n": len(reps), "dim": reps.shape[1],
        "mean": float(reps.mean()), "std": float(reps.std()),
        "min": float(reps.min()), "max": float(reps.max()),
        "label_histogram": hist.tolist(),
    }


def visualize_representations_tsne(reps: np.ndarray, labels: np.ndarray,
                                   path: str, pca_dim: int = 50,
                                   perplexity: float = 30.0
                                   ) -> Optional[str]:
    """PCA to ``pca_dim`` dimensions, then a 2-d t-SNE scatter coloured by
    class, written to ``path``. Returns ``path``, or None (with a printed
    line) when scikit-learn or matplotlib is not installed."""
    try:
        from sklearn.decomposition import PCA
        from sklearn.manifold import TSNE
    except ImportError:
        print(f"[analyze] scikit-learn is not installed: {path} not written")
        return None
    plt = _pyplot(path)
    if plt is None:
        return None
    x = reps
    if x.shape[1] > pca_dim:
        x = PCA(n_components=min(pca_dim, len(x) - 1)).fit_transform(x)
    perplexity = min(perplexity, max(2.0, (len(x) - 1) / 3))
    emb = TSNE(n_components=2, perplexity=perplexity,
               init="pca", random_state=0).fit_transform(x)
    fig, ax = plt.subplots(figsize=(8, 7))
    sc = ax.scatter(emb[:, 0], emb[:, 1], c=labels, cmap="tab10", s=12,
                    alpha=0.8)
    fig.colorbar(sc, ax=ax, label="class")
    ax.set_title("UNet pre-tail representations (PCA -> t-SNE)")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def visualize_representation_evolution(
        per_epoch: Dict[int, Tuple[np.ndarray, np.ndarray]],
        path: str) -> Optional[str]:
    """The mean +- std of the activations, epoch by epoch, written to
    ``path``. Returns ``path``, or None (with a printed line) when
    matplotlib is not installed."""
    plt = _pyplot(path)
    if plt is None:
        return None
    epochs = sorted(per_epoch)
    means = [per_epoch[e][0].mean() for e in epochs]
    stds = [per_epoch[e][0].std() for e in epochs]
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.errorbar(epochs, means, yerr=stds, marker="o", capsize=3)
    ax.set_xlabel("epoch")
    ax.set_ylabel("representation activation (mean ± std)")
    ax.set_title("Representation evolution during training")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="itsd_tpu_torch.cli.analyze")
    # the reference's spellings (--representation_dir, --output_dir) too
    p.add_argument("--repr-dir", "--representation_dir", required=True,
                   dest="repr_dir")
    p.add_argument("--out-dir", "--output_dir", default="./analysis",
                   dest="out_dir")
    p.add_argument("--epoch", type=int, default=None,
                   help="analyze this epoch only (default: stats for all, "
                        "t-SNE of the last)")
    p.add_argument("--max-samples", "--max_samples", type=int, default=1000,
                   dest="max_samples",
                   help="subsample cap for the t-SNE embedding")
    p.add_argument("--pca-dim", type=int, default=50)
    p.add_argument("--perplexity", type=float, default=30.0)
    args = p.parse_args(argv)

    per_epoch = load_representations(args.repr_dir)
    if args.epoch is not None:
        per_epoch = {e: v for e, v in per_epoch.items() if e == args.epoch}
    if not per_epoch:
        print(f"no representation files found in {args.repr_dir}"
              + (f" for epoch {args.epoch}" if args.epoch is not None
                 else ""))
        return 1
    for epoch, (reps, labels) in per_epoch.items():
        print(f"epoch {epoch}: {representation_stats(reps, labels)}")
    last = max(per_epoch)
    reps, labels = per_epoch[last]
    if len(reps) > args.max_samples:
        sel = np.random.default_rng(0).choice(len(reps), args.max_samples,
                                              replace=False)
        reps, labels = reps[sel], labels[sel]
    visualize_representations_tsne(
        reps, labels, os.path.join(args.out_dir, f"tsne_epoch_{last}.png"),
        pca_dim=args.pca_dim, perplexity=args.perplexity)
    visualize_representation_evolution(
        per_epoch, os.path.join(args.out_dir, "representation_evolution.png"))
    print(f"wrote analysis to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

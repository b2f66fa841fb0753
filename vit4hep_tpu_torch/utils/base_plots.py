"""Training-curve plots of a run (counterpart of
``vit4hep_tpu/utils/base_plots.py``). matplotlib is imported inside the
functions, so the package imports on hosts without it."""

from __future__ import annotations

import numpy as np


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, imported at first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_loss(filename, train_loss, val_loss=None, val_every=1, logy=True):
    """Training (and optionally validation) loss curve."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(np.arange(1, len(train_loss) + 1), train_loss, lw=0.8, label="train", color="#0000cc")
    if val_loss is not None and len(val_loss):
        ax.plot(np.arange(1, len(val_loss) + 1) * val_every, val_loss, lw=1.2,
                label="validation", color="#cc0000")
    if logy and np.all(np.asarray(train_loss) > 0):
        ax.set_yscale("log")
    ax.set_xlabel("iteration")
    ax.set_ylabel("loss")
    ax.legend(frameon=False)
    fig.tight_layout()
    fig.savefig(filename, dpi=200)
    plt.close(fig)


def plot_metric(filename, values, ylabel, logy=False):
    """A per-iteration metric curve (learning rate, grad norm, ...)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(np.arange(1, len(values) + 1), values, lw=0.8, color="#0000cc")
    if logy and np.all(np.asarray(values) > 0):
        ax.set_yscale("log")
    ax.set_xlabel("iteration")
    ax.set_ylabel(ylabel)
    fig.tight_layout()
    fig.savefig(filename, dpi=200)
    plt.close(fig)

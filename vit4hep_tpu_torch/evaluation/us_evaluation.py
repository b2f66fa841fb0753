"""u-space (per-layer energy-ratio) evaluation of energy models (port of
``vit4hep_tpu/evaluation/us_evaluation.py``): one ratio-panel histogram per
u_i (:func:`plot_ui_dists`, which needs matplotlib) and a DNN classifier
test on the u-vectors (:func:`eval_ui_dists`, torch on ``device``).
"""

from __future__ import annotations

import os

import numpy as np

from vit4hep_tpu_torch.evaluation.classifiers import run_dnn_classifier


def _eval_dir(cfg):
    out = os.path.join(str(cfg.run_dir), f"eval_{cfg.run_idx}")
    os.makedirs(out, exist_ok=True)
    return out


def plot_ui_dists(gen_us, ref_us, xlim=(-0.05, 1.05), num_bins=64, cfg=None, labels=("Model",)):
    """One 3-panel histogram per u_i. For u_0 = E_tot / E_inc (which can
    exceed 1) the range comes from the data; the other ratios end at 1.05."""
    from vit4hep_tpu_torch.evaluation.plots import ratio_panel

    out_dir = _eval_dir(cfg) if cfg is not None else None
    for i, (ref, gen) in enumerate(zip(np.asarray(ref_us).T, np.asarray(gen_us).T, strict=True)):
        both = np.concatenate([ref, gen])
        if i == 0 or xlim == "auto":
            lo, hi = float(both.min()), float(both.max())
        else:
            lo, hi = xlim[0], 1.05
        bins = np.linspace(lo, hi, num_bins)
        ratio_panel([gen], ref, bins, f"$u_{{{i}}}$", list(labels), ref_label="Geant",
                    filename=os.path.join(out_dir, f"u{i}_dist.pdf") if out_dir else None)


def eval_ui_dists(source_array, reference_array, cfg, device="cuda"):
    """The DNN classifier on the u-vectors, generated (label 0) against the
    reference (label 1); appends AUC / JSD to
    ``eval_<run_idx>/classifier_<mode>_<dataset>.txt``. Returns (acc, auc,
    jsd)."""
    out_dir = _eval_dir(cfg)
    ev = cfg.evaluation
    src = np.concatenate([np.asarray(source_array), np.zeros((len(source_array), 1))], axis=1)
    ref = np.concatenate([np.asarray(reference_array), np.ones((len(reference_array), 1))],
                         axis=1)
    return run_dnn_classifier(
        src, ref, ev, os.path.join(out_dir, f"classifier_{ev.eval_mode}_{ev.eval_dataset}.txt"),
        device=device)

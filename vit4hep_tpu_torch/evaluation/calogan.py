"""CaloGAN's low-level classifier evaluation (port of
``vit4hep_tpu/evaluation/calogan.py``): a DNN on the flat 504 voxels, real
against generated, with isotonic calibration and AUC/JSD.

:func:`evaluate_calogan` works on arrays; :func:`eval_calogan_lowlevel`
reads the reference file (h5py) and calls it."""

from __future__ import annotations

import os

import numpy as np

from vit4hep_tpu_torch.evaluation.classifiers import run_dnn_classifier

LAYER_VOXELS = (288, 144, 72)


def reference_showers(ref):
    """The flat (N, 504) showers of a dict as ``data/calogan/datasets.load_data``
    gives it."""
    return np.concatenate([np.asarray(ref[f"layer_{i}"]).reshape(-1, n)
                           for i, n in enumerate(LAYER_VOXELS)], axis=1)


def evaluate_calogan(source_array, reference_array, cfg, device="cuda"):
    """The DNN test of generated (N, 504) showers (label 0) against the
    reference's (label 1); writes the AUC / JSD line under
    ``<run_dir>/eval_<run_idx>/`` and returns (acc, auc, jsd)."""
    ev = cfg.evaluation
    out_dir = os.path.join(str(cfg.run_dir), f"eval_{cfg.run_idx}")
    os.makedirs(out_dir, exist_ok=True)
    src = np.concatenate([np.asarray(source_array), np.zeros((len(source_array), 1))], axis=1)
    ref = np.concatenate([np.asarray(reference_array), np.ones((len(reference_array), 1))],
                         axis=1)
    return run_dnn_classifier(
        src, ref, ev, os.path.join(out_dir, f"classifier_{ev.eval_mode}_{ev.eval_dataset}.txt"),
        device=device)


def eval_calogan_lowlevel(source_array, cfg, device="cuda"):
    """:func:`evaluate_calogan` against ``cfg.evaluation.eval_hdf5_file``."""
    from vit4hep_tpu_torch.data.calogan.datasets import load_data

    reference = reference_showers(load_data(str(cfg.evaluation.eval_hdf5_file)))
    return evaluate_calogan(source_array, reference, cfg, device)

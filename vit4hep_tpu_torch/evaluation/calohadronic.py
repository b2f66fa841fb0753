"""CaloHadronic's evaluation (port of
``vit4hep_tpu/evaluation/calohadronic.py``): shower centroids, E_tot /
E_inc, hit counts and per-layer energies; feature histograms, and a DNN
classifier on the standardized features against the (sum-pooled) Geant4
reference.

:func:`evaluate_calohad` works on arrays; :func:`run_from_py` reads the
reference file (h5py) and calls it. The histograms need matplotlib
(``draw``)."""

from __future__ import annotations

import os

import numpy as np

from vit4hep_tpu_torch.data.calohadronic.transforms import sum_pool
from vit4hep_tpu_torch.evaluation.classifiers import run_dnn_classifier
from vit4hep_tpu_torch.utils.logger import LOGGER

MIN_ENERGY = 1.0e-6


def get_centroid_z(ecal, hcal):
    """Energy-weighted mean layer index over both calorimeters."""
    profile = np.concatenate([ecal.mean((-1, -2)), hcal.mean((-1, -2))], axis=1)
    idx = np.arange(profile.shape[1])[None, :]
    return (idx * profile).sum(1) / profile.sum(-1)


def _transverse_centroid(ecal, hcal, axis_e, axis_h, ecalmm):
    hcal_mm = 30
    ecal_avg = ecal.mean(axis_e)
    hcal_avg = hcal.mean(axis_h)
    pos_e = (np.arange(ecal_avg.shape[1]) * ecalmm)[None, :]
    pos_h = (np.arange(hcal_avg.shape[1]) * hcal_mm)[None, :]
    weighted = np.concatenate([ecal_avg * pos_e, hcal_avg * pos_h], axis=1)
    total = np.concatenate([ecal_avg, hcal_avg], axis=1)
    return weighted.sum(1) / total.sum(-1) - 430.0


def get_centroid_x(ecal, hcal, ecalmm=5.1):
    return _transverse_centroid(ecal, hcal, (-1, -3), (-1, -3), ecalmm)


def get_centroid_y(ecal, hcal, ecalmm=5.1):
    return _transverse_centroid(ecal, hcal, (-2, -3), (-2, -3), ecalmm)


def get_total_energy(ecal, hcal):
    return ecal.sum((-1, -2, -3)) + hcal.sum((-1, -2, -3))


def get_n_hits(ecal, hcal, threshold=1.0e-6):
    return (ecal > threshold).sum((-1, -2, -3)) + (hcal > threshold).sum((-1, -2, -3))


def _sum_pool_ecal(ecal, kernel=(3, 12, 12)):
    return sum_pool(ecal, kernel)


FEATURES = [
    ("cog_x", r"$\langle x \rangle$ [mm]"),
    ("cog_y", r"$\langle y \rangle$ [mm]"),
    ("cog_z", r"$\langle z \rangle$ layer number"),
    ("energy", r"$E_{tot}/E_{inc}$"),
    ("nhits", r"$n_{hits}$"),
]


def features(ecal, hcal, energy):
    """The five shower features of :data:`FEATURES`, each (N,)."""
    return {
        "cog_x": get_centroid_x(ecal, hcal, ecalmm=5.1 * 12),
        "cog_y": get_centroid_y(ecal, hcal, ecalmm=5.1 * 12),
        "cog_z": get_centroid_z(ecal, hcal),
        "energy": get_total_energy(ecal, hcal) / energy.flatten(),
        "nhits": get_n_hits(ecal, hcal, threshold=MIN_ENERGY).astype(np.float64),
    }


def classifier_arrays(f_gen, f_g4, layer_e_gen, layer_e_g4):
    """The classifier's labelled inputs: the features standardized by the
    generated set's mean and std, the per-layer energies, and the label
    (1 generated, 0 Geant4)."""
    stats = {k: (v.mean(), v.std() + 1e-12) for k, v in f_gen.items()}

    def stacked(f, n, label):
        cols = [(f[k] - stats[k][0]) / stats[k][1] for k, _ in FEATURES]
        return np.stack(cols, axis=1), np.full((n, 1), label)

    gen, gen_label = stacked(f_gen, len(layer_e_gen), 1.0)
    g4, g4_label = stacked(f_g4, len(layer_e_g4), 0.0)
    return (np.concatenate([gen, layer_e_gen, gen_label], axis=1),
            np.concatenate([g4, layer_e_g4, g4_label], axis=1))


def run_from_py(ecal, hcal, energy, cfg, device="cuda"):
    """:func:`evaluate_calohad` against ``cfg.evaluation.eval_hdf5_file``."""
    import h5py  # host-side reader; the card's machine has none

    from vit4hep_tpu_torch.data.calohadronic.datasets import load_data

    with h5py.File(str(cfg.evaluation.eval_hdf5_file), "r") as f:
        ref = load_data(f, local_index=None)
    return evaluate_calohad(ecal, hcal, energy, ref, cfg, device)


def evaluate_calohad(ecal, hcal, energy, ref, cfg, device="cuda", draw=True):
    """Generated ECal (N, 10, 15, 15), HCal (N, 48, 30, 30) and incident
    energies against the reference dict (``ecal`` raw 30x180x180 or
    pooled, ``hcal``, ``energy``): the feature and voxel histograms (with
    ``draw``) and the DNN test, under ``<run_dir>/eval_<run_idx>/``.
    Returns (acc, auc, jsd)."""
    LOGGER.info("Running CaloHadronic evaluation:")
    output_dir = os.path.join(str(cfg.run_dir), f"eval_{cfg.run_idx}")
    os.makedirs(output_dir, exist_ok=True)
    ecal = np.array(ecal)
    hcal = np.array(hcal)
    energy = np.asarray(energy).reshape(-1, 1)
    # the reference ECal arrives raw (30x180x180): sum-pooled to the generated grid
    ecal_g4 = _sum_pool_ecal(ref["ecal"]) if ref["ecal"].shape[1:] != ecal.shape[1:] \
        else np.array(ref["ecal"])
    hcal_g4 = np.array(ref["hcal"])
    energy_g4 = np.asarray(ref["energy"]).reshape(-1, 1)
    for arr in (ecal, hcal, ecal_g4, hcal_g4):
        arr[arr < MIN_ENERGY] = 0.0

    f_gen = features(ecal, hcal, energy)
    f_g4 = features(ecal_g4, hcal_g4, energy_g4)
    if draw:
        _histograms(f_gen, f_g4, ecal, hcal, ecal_g4, hcal_g4, output_dir)
    layer_e_gen = np.concatenate([ecal.sum((-1, -2)), hcal.sum((-1, -2))], axis=1)
    layer_e_g4 = np.concatenate([ecal_g4.sum((-1, -2)), hcal_g4.sum((-1, -2))], axis=1)
    gen_arr, g4_arr = classifier_arrays(f_gen, f_g4, layer_e_gen, layer_e_g4)
    return run_dnn_classifier(gen_arr, g4_arr, cfg.evaluation,
                              os.path.join(output_dir, "classifier.txt"), device=device)


def _histograms(f_gen, f_g4, ecal, hcal, ecal_g4, hcal_g4, output_dir):
    from vit4hep_tpu_torch.evaluation.plots import ratio_panel

    for name, label in FEATURES:
        both = np.concatenate([f_gen[name], f_g4[name]])
        bins = np.linspace(np.nanmin(both), np.nanmax(both) + 1e-9, 41)
        ratio_panel([f_gen[name]], f_g4[name], bins, label, ["ViT-CFM"],
                    filename=os.path.join(output_dir, f"{name}_CaloHad.pdf"))
    vox_gen = np.concatenate([ecal.ravel(), hcal.ravel()])
    vox_g4 = np.concatenate([ecal_g4.ravel(), hcal_g4.ravel()])
    lv_gen = np.log10(vox_gen[vox_gen > 0])
    lv_g4 = np.log10(vox_g4[vox_g4 > 0])
    bins = np.linspace(min(lv_gen.min(), lv_g4.min()), max(lv_gen.max(), lv_g4.max()), 41)
    ratio_panel([lv_gen], lv_g4, bins, r"$\log_{10} E_{voxel}$ [GeV]", ["ViT-CFM"],
                filename=os.path.join(output_dir, "voxels_CaloHad.pdf"))

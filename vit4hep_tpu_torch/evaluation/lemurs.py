"""LEMURS's evaluation (port of ``vit4hep_tpu/evaluation/lemurs.py``): the
reference sliced by condition windows, the CaloChallenge histogram suite
with the z / r energy profiles and the condition histograms, FPD/KPD and
the classifier tests, on showers moved to the CaloChallenge voxel layout.

:func:`evaluate_lemurs` works on arrays; :func:`run_from_py` reads the
reference's ``events`` table (h5py) and calls it. The drawing modes import
``plots`` (matplotlib) in their branches."""

from __future__ import annotations

import os

import numpy as np

from vit4hep_tpu_torch.evaluation.high_level_features import HighLevelFeatures
from vit4hep_tpu_torch.evaluation.metrics import fpd, kpd
from vit4hep_tpu_torch.evaluation.ugr_evaluation import (EvalArgs, _run_classifier,
                                                          prepare_high_data_for_classifier,
                                                          prepare_low_data_for_classifier)
from vit4hep_tpu_torch.utils.logger import LOGGER


def extract_shower_and_energy(events, max_len=-1, energy_bin=None, theta_bin=None,
                              phi_bin=None):
    """(showers, E, theta, phi) of the events inside the condition windows
    (``[lo, hi)`` each), at most ``max_len`` of them."""
    shower = np.asarray(events["showers"])
    energy = np.asarray(events["incident_energy"]).reshape(-1, 1)
    theta = np.asarray(events["incident_theta"]).reshape(-1, 1)
    phi = np.asarray(events["incident_phi"]).reshape(-1, 1)
    mask = np.ones(len(energy), bool)
    for arr, win in ((energy, energy_bin), (theta, theta_bin), (phi, phi_bin)):
        if win is not None:
            mask &= ((arr >= win[0]) & (arr < win[1])).squeeze()
    return tuple(a[mask][:max_len].astype(np.float32) for a in (shower, energy, theta, phi))


class LemursArgs(EvalArgs):
    """CaloChallenge's evaluation options (``eval_dataset`` "2" sets the
    particle and the minimum energy) with the slicing windows; files are
    tagged "LEMURS"."""

    def __init__(self, cfg, device="cuda"):
        ev = cfg.evaluation
        super().__init__(cfg, device)
        self.dataset = "LEMURS"
        # YAML reads 1e3 as a string
        windows = [ev.get(f"eval_{k}_bin") for k in ("energy", "theta", "phi")]
        self.energy_bin, self.theta_bin, self.phi_bin = (
            [float(v) for v in w] if w else None for w in windows)


def run_from_py(sample, energy, theta, phi, cfg, device="cuda"):
    """:func:`evaluate_lemurs` against the ``events`` table of
    ``cfg.evaluation.eval_hdf5_file``."""
    import h5py  # host-side reader; the card's machine has none

    with h5py.File(str(cfg.evaluation.eval_hdf5_file), "r") as f:
        events = f["events"][:]
    return evaluate_lemurs(sample, energy, theta, phi, events, cfg, device)


def evaluate_lemurs(sample, energy, theta, phi, events, cfg, device="cuda"):
    """The evaluation of ``cfg.evaluation.eval_mode`` on arrays: generated
    (B, H, W, L) showers with their E, theta and phi against the reference
    ``events`` (a table or dict with ``showers`` and ``incident_*``). Writes
    into ``<run_dir>/eval_<run_idx>/`` and returns each classifier's
    ``{"acc", "auc", "jsd"}`` by key and, where computed, ``"fpd"`` and
    ``"kpd"`` as ``{"value", "error"}``."""
    LOGGER.info("Running LEMURS evaluation:")
    arg = LemursArgs(cfg, device)
    arg.output_dir = os.path.join(str(cfg.run_dir), f"eval_{cfg.run_idx}")
    os.makedirs(arg.output_dir, exist_ok=True)
    results = {}

    sample = np.array(sample)
    num_voxels = int(np.prod(sample.shape[1:]))
    hlf = HighLevelFeatures(arg.particle, filename=cfg.data.xml_filename)
    # the CaloChallenge voxel layout: (B, H, W, L) -> (B, L, W, H), flat
    sample = sample.transpose(0, 3, 2, 1).reshape(-1, num_voxels)
    np.nan_to_num(sample, copy=False, nan=0.0, neginf=0.0, posinf=0.0)
    sample[sample < arg.cut] = 0.0
    sample_conds = np.concatenate([energy, theta, phi], axis=1)

    LOGGER.info(f"slicing with energy bin {arg.energy_bin}, theta bin {arg.theta_bin}, "
                f"phi bin {arg.phi_bin}")
    reference_shower, reference_energy, reference_theta, reference_phi = \
        extract_shower_and_energy(events, max_len=len(sample), energy_bin=arg.energy_bin,
                                  theta_bin=arg.theta_bin, phi_bin=arg.phi_bin)
    LOGGER.info(f"reference showers after slicing: {len(reference_energy)}")
    reference_shower = reference_shower.transpose(0, 3, 2, 1).reshape(-1, num_voxels)
    reference_shower[reference_shower < arg.cut] = 0.0
    reference_hlf = HighLevelFeatures(arg.particle, filename=cfg.data.xml_filename)
    reference_hlf.Einc = reference_energy
    reference_conds = np.concatenate([reference_energy, reference_theta, reference_phi], axis=1)

    if arg.mode in ("all", "no-cls", "avg"):
        from vit4hep_tpu_torch.evaluation import plots

        plots.plot_layer_comparison(hlf, sample.mean(axis=0, keepdims=True), reference_hlf,
                                    reference_shower.mean(axis=0, keepdims=True), arg)
        hlf.DrawAverageShower(
            sample, filename=os.path.join(arg.output_dir,
                                          f"average_shower_dataset_{arg.dataset}.png"),
            title="Shower average")
        hlf.DrawAverageShower(
            reference_shower.mean(axis=0, keepdims=True),
            filename=os.path.join(arg.output_dir,
                                  f"reference_average_shower_dataset_{arg.dataset}.png"),
            title="Shower average reference dataset")

    if arg.mode != "avg":
        LOGGER.info("Calculating high-level features ...")
        hlf.CalculateFeatures(sample)
        hlf.Einc = energy
        if reference_hlf.E_tot is None:
            reference_hlf.CalculateFeatures(reference_shower)

    if arg.mode in ("all", "no-cls", "hist-p", "hist-chi", "hist"):
        from vit4hep_tpu_torch.evaluation import plots

        with open(os.path.join(arg.output_dir, f"histogram_chi2_{arg.dataset}.txt"), "w",
                  encoding="utf-8") as f:
            f.write("List of chi2 of the plotted histograms (eq. 15 of 2009.03796).\n")
        LOGGER.info("Plotting histograms ...")
        common = ([hlf], reference_hlf, arg, arg.labels, [""], arg.p_label)
        for draw in (plots.plot_Etot_Einc_scaled, plots.plot_E_layers, plots.plot_ECEtas,
                     plots.plot_ECPhis, plots.plot_ECWidthEtas, plots.plot_ECWidthPhis,
                     plots.plot_sparsity, plots.plot_weighted_depth_a,
                     plots.plot_weighted_depth_r, plots.plot_z_profile, plots.plot_r_profile):
            draw(*common)
        plots.plot_cell_dist([sample], reference_shower, arg, arg.labels, [""], arg.p_label)
        plots.plot_conditions(sample_conds, reference_conds, arg, arg.labels, [""], arg.p_label)

    if arg.mode in ("all", "fpd", "kpd"):
        LOGGER.info("Computing FPD/KPD ...")
        src = prepare_high_data_for_classifier(sample, energy, hlf, 0.0)[:, :-1]
        ref = prepare_high_data_for_classifier(reference_shower, reference_energy,
                                               reference_hlf, 1.0)[:, :-1]
        fpd_val, fpd_err = fpd(ref, src, min_samples=10000, device=device)
        kpd_val, kpd_err = kpd(ref, src, batch_size=10000, device=device)
        results["fpd"] = {"value": fpd_val, "error": fpd_err}
        results["kpd"] = {"value": kpd_val, "error": kpd_err}
        result = (f"FPD (x10^3): {fpd_val * 1e3:.4f} ± {fpd_err * 1e3:.4f}\n"
                  f"KPD (x10^3): {kpd_val * 1e3:.4f} ± {kpd_err * 1e3:.4f}")
        LOGGER.info(result)
        with open(os.path.join(arg.output_dir, f"fpd_kpd_{arg.dataset}.txt"), "w",
                  encoding="utf-8") as f:
            f.write(result)

    if arg.mode in ("all", "all-cls", "cls-low", "cls-high", "cls-low-normed", "cls-resnet"):
        list_cls = ["cls-low", "cls-high", "cls-resnet"] if arg.mode in ("all", "all-cls") \
            else [arg.mode]
        for key in list_cls:
            LOGGER.info(f"Training classifier {key} ...")
            if key in ("cls-low", "cls-resnet", "cls-low-normed"):
                normed = key == "cls-low-normed"
                src = prepare_low_data_for_classifier(sample, energy, hlf, 0.0, cut=arg.cut,
                                                      normed=normed)
                ref = prepare_low_data_for_classifier(reference_shower, reference_energy,
                                                      reference_hlf, 1.0, cut=arg.cut,
                                                      normed=normed)
            else:
                src = prepare_high_data_for_classifier(sample, energy, hlf, 0.0, cut=arg.cut)
                ref = prepare_high_data_for_classifier(reference_shower, reference_energy,
                                                       reference_hlf, 1.0, cut=arg.cut)
            acc, auc, jsd = _run_classifier(key, src, ref, arg)
            results[key] = {"acc": acc, "auc": auc, "jsd": jsd}
            LOGGER.info(f"{key}: AUC {auc:.4f} / JSD {jsd:.4f}")
    return results

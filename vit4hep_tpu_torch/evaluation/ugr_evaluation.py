"""CaloChallenge evaluation harness (port of
``vit4hep_tpu/evaluation/ugr_evaluation.py``): sanity checks and the
low-energy cut, the reference read with its shape checks, average and
single shower images, the histogram suite with chi^2 separation powers,
the classifier tests (DNN on low-level, low-normed and high-level features;
3-D ResNet on the voxels) with isotonic calibration and AUC/JSD, and FPD/KPD
on high-level features.

:func:`evaluate_showers` does the work on arrays: the generated showers and
energies against the reference's. :func:`run_from_py` reads the reference
from ``cfg.evaluation.eval_hdf5_file`` (h5py, imported there) and calls it.
The drawing modes import ``plots`` (matplotlib) in their branches; the
classifier and FPD/KPD modes need neither matplotlib nor h5py nor sklearn,
and train the classifiers on ``device``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from vit4hep_tpu_torch.evaluation.classifiers import (
    DNN,
    ClassifierConfig,
    evaluate_classifier,
    generate_model,
    train_classifier,
    ttv_split,
)
from vit4hep_tpu_torch.evaluation.high_level_features import HighLevelFeatures
from vit4hep_tpu_torch.evaluation.metrics import fpd, kpd
from vit4hep_tpu_torch.utils.logger import LOGGER

DATASET_NUM_FEATURES = {
    "1-photons": 368,
    "1-pions": 533,
    "2": 6480,
    "3": 40500,
    "LEMURS": 6480,
}
DATASET_PARTICLE = {
    "1-photons": "photon",
    "1-pions": "pion",
    "2": "electron",
    "3": "electron",
    "LEMURS": "gamma",
}
DATASET_MIN_ENERGY = {
    "1-photons": 0.001,
    "1-pions": 0.001,
    "2": 0.5e-3 / 0.033,
    "3": 0.5e-3 / 0.033,
    "LEMURS": 0.5e-3 / 0.033,
}
DATASET_P_LABEL = {
    "1-photons": r"$\gamma$ ds-1",
    "1-pions": r"$\pi^{+}$ ds-1",
    "2": r"$e^{-}$ ds-2",
    "3": r"$e^{-}$ ds-3",
}
RESNET_IMG_SHAPE = {"2": (45, 16, 9), "3": (45, 50, 18), "LEMURS": (45, 16, 9)}


class EvalArgs:
    """Evaluation options pulled from cfg.evaluation (reference evaluate.py:383-404); ``device`` trains the classifiers."""

    def __init__(self, cfg, device="cuda"):
        ev = cfg.evaluation
        self.device = device
        self.dataset = str(ev.eval_dataset)
        self.mode = ev.eval_mode
        self.cut = float(ev.eval_cut)
        self.reference_file = ev.eval_hdf5_file
        self.p_label = ev.get("eval_p_label", "")
        self.labels = list(ev.get("eval_labels", ["ViT-CFM"]))
        self.cls_n_layer = int(ev.eval_cls_n_layer)
        self.cls_n_hidden = int(ev.eval_cls_n_hidden)
        self.cls_dropout_probability = float(ev.eval_cls_dropout)
        self.cls_lr = float(ev.eval_cls_lr)
        self.cls_batch_size = int(ev.eval_cls_batch_size)
        self.cls_n_epochs = int(ev.eval_cls_n_epochs)
        self.cls_resnet_layers = int(ev.get("eval_cls_resnet_layers", 18))
        self.cls_resnet_lr = float(ev.get("eval_cls_resnet_lr", 2e-4))
        self.cls_resnet_epochs = int(ev.get("eval_cls_resnet_n_epochs", 50))
        self.x_scale = "log"
        self.min_energy = DATASET_MIN_ENERGY[self.dataset]
        self.particle = DATASET_PARTICLE[self.dataset]


def check_file(given_file, arg, which=None):
    """Assert the HDF5 file has the expected voxel count (reference :322-353)."""
    n_feat = DATASET_NUM_FEATURES[arg.dataset]
    n_events = given_file["incident_energies"].shape[0]
    assert given_file["showers"].shape[0] == n_events, (
        f"Number of energies does not match number of showers, "
        f"{n_events} != {given_file['showers'].shape[0]}"
    )
    assert given_file["showers"].shape[1] == n_feat, (
        f"Showers have wrong shape, expected {n_feat}, got {given_file['showers'].shape[1]}"
    )
    LOGGER.info(f"check_file ({which}): {n_events} events, {n_feat} voxels — OK")


def extract_shower_and_energy(given_file, which, single_energy=None, max_len=-1):
    """Read showers + incident energies from an open HDF5 file (reference :356-367)."""
    if single_energy is not None:
        mask = given_file["incident_energies"][:] == single_energy
        energy = given_file["incident_energies"][:][mask].reshape(-1, 1)
        shower = given_file["showers"][:][mask.flatten()]
    else:
        shower = given_file["showers"][:max_len]
        energy = given_file["incident_energies"][:max_len]
    return shower.astype("float32", copy=False), energy.astype("float32", copy=False)


def prepare_low_data_for_classifier(voxel, e_inc, hlf_class, label, cut=0.0, normed=False):
    """[log10(Einc), voxels (Einc- or Elayer-normed), (log10 E_layers), label]
    (reference :68-102)."""
    voxel = np.array(voxel)
    e_inc = np.array(e_inc)
    if normed:
        e_layers = np.stack(
            [hlf_class.GetElayers()[k] for k in hlf_class.GetElayers()], axis=1
        )
        rep = np.concatenate(
            [
                np.repeat(e_layers[:, i : i + 1], nv, axis=1)
                for i, nv in enumerate(hlf_class.num_voxel)
            ],
            axis=1,
        )
        voxel = voxel / (rep + 1e-16)
        return np.concatenate(
            [np.log10(e_inc), voxel, np.log10(e_layers + 1e-8),
             label * np.ones_like(e_inc)], axis=1,
        )
    return np.concatenate(
        [np.log10(e_inc), voxel / e_inc, label * np.ones_like(e_inc)], axis=1
    )


def prepare_high_data_for_classifier(voxel, e_inc, hlf_class, label, cut=0.0):
    """[log10 Einc, log10 E_layers, ECs/100, widths/100, label] (reference :105-139)."""
    e_inc = np.array(e_inc)
    e_layer = np.stack([hlf_class.GetElayers()[k] for k in hlf_class.GetElayers()], axis=1)
    keys = hlf_class.layersBinnedInAlpha
    ec_eta = np.stack([hlf_class.GetECEtas()[k] for k in keys], axis=1)
    ec_phi = np.stack([hlf_class.GetECPhis()[k] for k in keys], axis=1)
    w_eta = np.stack([hlf_class.GetWidthEtas()[k] for k in keys], axis=1)
    w_phi = np.stack([hlf_class.GetWidthPhis()[k] for k in keys], axis=1)
    return np.concatenate(
        [
            np.log10(e_inc), np.log10(e_layer + 1e-8),
            ec_eta / 1e2, ec_phi / 1e2, w_eta / 1e2, w_phi / 1e2,
            label * np.ones_like(e_inc),
        ],
        axis=1,
    )


def _run_classifier(key, source_array, reference_array, arg):
    """Train, calibrate and score one classifier flavour; returns (acc, auc,
    jsd) and appends AUC / JSD to its result file."""
    train_data, test_data, val_data = ttv_split(source_array, reference_array)
    if key == "cls-resnet":
        cfg = ClassifierConfig(lr=arg.cls_resnet_lr, batch_size=arg.cls_batch_size,
                               n_epochs=arg.cls_resnet_epochs, optimizer="AdamW")
        model = generate_model(arg.cls_resnet_layers, img_shape=RESNET_IMG_SHAPE[arg.dataset],
                               generator=torch.Generator().manual_seed(cfg.seed))
    else:
        cfg = ClassifierConfig(lr=arg.cls_lr, batch_size=arg.cls_batch_size,
                               n_epochs=arg.cls_n_epochs)
        model = DNN(arg.cls_n_layer, arg.cls_n_hidden, arg.cls_dropout_probability,
                    num_inputs=train_data.shape[1] - 1,
                    generator=torch.Generator().manual_seed(cfg.seed))
    _, apply_fn = train_classifier(model, train_data, test_data, cfg, device=arg.device)
    acc, auc, jsd = evaluate_classifier(apply_fn, val_data, calibration_data=test_data,
                                        final_eval=True)
    with open(os.path.join(arg.output_dir, f"classifier_{arg.mode}_{key}_{arg.dataset}.txt"),
              "a", encoding="utf-8") as f:
        f.write(f"Final result of classifier test (AUC / JSD):\n{auc:.4f} / {jsd:.4f}\n\n")
    return acc, auc, jsd


def run_from_py(sample, energy, cfg, device="cuda"):
    """Full evaluation of generated showers (MeV) and their incident
    energies against the reference file; returns :func:`evaluate_showers`'
    results."""
    import h5py  # host-side reader; the card's machine has none

    arg = EvalArgs(cfg, device)
    with h5py.File(arg.reference_file, "r") as f:
        check_file(f, arg, which="reference")
        reference_shower, reference_energy = extract_shower_and_energy(
            f, which="reference", max_len=len(sample))
    return evaluate_showers(sample, energy, reference_shower, reference_energy, cfg, device)


def evaluate_showers(sample, energy, reference_shower, reference_energy, cfg, device="cuda"):
    """The evaluation of ``cfg.evaluation.eval_mode`` on arrays: generated
    showers (N, voxels) in MeV with their incident energies (N, 1) against
    the reference's. Writes into ``<run_dir>/eval_<run_idx>/`` and returns
    a dict: each classifier's ``{"acc", "auc", "jsd", "seconds"}`` by key,
    and where computed ``"fpd"`` and ``"kpd"`` as ``{"value", "error",
    "seconds"}`` (host clock, the device synchronised)."""
    LOGGER.info("Running evaluation script run_from_py:")
    arg = EvalArgs(cfg, device)
    arg.output_dir = os.path.join(str(cfg.run_dir), f"eval_{cfg.run_idx}")
    os.makedirs(arg.output_dir, exist_ok=True)
    results = {}

    sample = np.array(sample)
    energy = np.asarray(energy)
    LOGGER.info(f"input {sample.shape}; negatives {(sample < 0).sum()}, "
                f"nans {np.isnan(sample).sum()}, infs {np.isinf(sample).sum()}")
    np.nan_to_num(sample, copy=False, nan=0.0, neginf=0.0, posinf=0.0)
    sample[sample < arg.cut] = 0.0

    hlf = HighLevelFeatures(arg.particle, filename=cfg.data.xml_filename)
    reference_shower = np.array(reference_shower)
    reference_shower[reference_shower < arg.cut] = 0.0
    reference_hlf = HighLevelFeatures(arg.particle, filename=cfg.data.xml_filename)
    reference_hlf.Einc = reference_energy

    if arg.mode in ("all", "no-cls", "avg"):
        from vit4hep_tpu_torch.evaluation import plots

        LOGGER.info("Plotting average/single showers ...")
        plots.plot_layer_comparison(
            hlf, sample.mean(axis=0, keepdims=True),
            reference_hlf, reference_shower.mean(axis=0, keepdims=True), arg,
        )
        hlf.DrawAverageShower(
            sample,
            filename=os.path.join(arg.output_dir, f"average_shower_dataset_{arg.dataset}.png"),
            title="Shower average",
        )
        hlf.DrawAverageShower(
            reference_shower.mean(axis=0, keepdims=True),
            filename=os.path.join(
                arg.output_dir, f"reference_average_shower_dataset_{arg.dataset}.png"
            ),
            title="Shower average reference dataset",
        )
        hlf.DrawSingleShower(
            sample[:5],
            filename=os.path.join(arg.output_dir, f"single_shower_dataset_{arg.dataset}.png"),
            title="Single shower",
        )
        hlf.DrawSingleShower(
            reference_shower[:5],
            filename=os.path.join(
                arg.output_dir, f"reference_single_shower_dataset_{arg.dataset}.png"
            ),
            title="Reference single shower",
        )

    if arg.mode in ("all", "no-cls", "avg-E"):
        LOGGER.info("Plotting average showers per energy window ...")
        if "1" in arg.dataset:
            target_energies = 2.0 ** np.linspace(8, 23, 16)
            titles = [f"shower average at E = {int(e)} MeV" for e in target_energies]
        else:
            target_energies = 10.0 ** np.linspace(3, 6, 4)
            titles = [
                f"shower average for E in [{10**i}, {10 ** (i + 1)}] MeV" for i in range(3, 7)
            ]
        for i in range(len(target_energies) - 1):
            lo, hi = target_energies[i], target_energies[i + 1]
            name = f"average_shower_dataset_{arg.dataset}_E_{lo}.png"
            sel = ((energy >= lo) & (energy < hi)).squeeze()
            if sel.any():
                hlf.DrawAverageShower(
                    sample[sel], filename=os.path.join(arg.output_dir, name),
                    title=titles[i],
                )
            sel_ref = ((reference_energy >= lo) & (reference_energy < hi)).squeeze()
            if sel_ref.any():
                hlf.DrawAverageShower(
                    reference_shower[sel_ref],
                    filename=os.path.join(arg.output_dir, "reference_" + name),
                    title="reference " + titles[i],
                )

    needs_features = arg.mode in (
        "all", "no-cls", "hist-p", "hist-chi", "hist",
        "all-cls", "cls-low", "cls-high", "cls-low-normed", "cls-resnet", "fpd", "kpd",
    )
    if needs_features:
        LOGGER.info("Calculating high-level features ...")
        hlf.CalculateFeatures(sample)
        hlf.Einc = energy
        if reference_hlf.E_tot is None:
            reference_hlf.CalculateFeatures(reference_shower)

    if arg.mode in ("all", "no-cls", "hist-p", "hist-chi", "hist"):
        chi2_txt = os.path.join(arg.output_dir, f"histogram_chi2_{arg.dataset}.txt")
        with open(chi2_txt, "w", encoding="utf-8") as f:
            f.write(
                "List of chi2 of the plotted histograms,"
                " see eq. 15 of 2009.03796 for its definition.\n"
            )
        from vit4hep_tpu_torch.evaluation import plots

        p_label = DATASET_P_LABEL.get(arg.dataset, arg.p_label)
        LOGGER.info("Plotting histograms ...")
        common = ([hlf], reference_hlf, arg, arg.labels, [""], p_label)
        plots.plot_Etot_Einc(*common)
        plots.plot_E_layers(*common)
        plots.plot_ECEtas(*common)
        plots.plot_ECPhis(*common)
        plots.plot_ECWidthEtas(*common)
        plots.plot_ECWidthPhis(*common)
        plots.plot_sparsity(*common)
        plots.plot_weighted_depth_a(*common)
        plots.plot_weighted_depth_r(*common)
        plots.plot_cell_dist([sample], reference_shower, arg, arg.labels, [""], p_label)

    if arg.mode in ("all", "all-cls", "cls-low", "cls-high", "cls-low-normed", "cls-resnet"):
        if arg.mode in ("all", "all-cls"):
            list_cls = ["cls-low", "cls-high"]
            if arg.dataset not in ("1-photons", "1-pions"):
                list_cls.append("cls-resnet")
        else:
            list_cls = [arg.mode]
        for key in list_cls:
            LOGGER.info(f"Training classifier {key} ...")
            if key in ("cls-low", "cls-resnet"):
                src = prepare_low_data_for_classifier(sample, energy, hlf, 0.0, cut=arg.cut)
                ref = prepare_low_data_for_classifier(
                    reference_shower, reference_energy, reference_hlf, 1.0, cut=arg.cut
                )
            elif key == "cls-low-normed":
                src = prepare_low_data_for_classifier(
                    sample, energy, hlf, 0.0, cut=arg.cut, normed=True
                )
                ref = prepare_low_data_for_classifier(
                    reference_shower, reference_energy, reference_hlf, 1.0,
                    cut=arg.cut, normed=True,
                )
            else:
                src = prepare_high_data_for_classifier(sample, energy, hlf, 0.0, cut=arg.cut)
                ref = prepare_high_data_for_classifier(
                    reference_shower, reference_energy, reference_hlf, 1.0, cut=arg.cut
                )
            t0 = time.perf_counter()
            acc, auc, jsd = _run_classifier(key, src, ref, arg)
            results[key] = {"acc": acc, "auc": auc, "jsd": jsd,
                            "seconds": time.perf_counter() - t0}
            LOGGER.info(f"{key}: AUC {auc:.4f} / JSD {jsd:.4f}")

    if arg.mode in ("all", "fpd", "kpd"):
        LOGGER.info("Computing FPD/KPD on high-level features ...")
        src = prepare_high_data_for_classifier(sample, energy, hlf, 0.0, cut=arg.cut)[:, :-1]
        ref = prepare_high_data_for_classifier(
            reference_shower, reference_energy, reference_hlf, 1.0, cut=arg.cut
        )[:, :-1]
        # exact reference invocation (evaluate.py:778-783): jetnet draws with
        # replacement, so no clamping to the available statistics is needed
        t0 = time.perf_counter()
        fpd_val, fpd_err = fpd(ref, src, min_samples=10000, device=device)
        t1 = time.perf_counter()
        kpd_val, kpd_err = kpd(ref, src, batch_size=10000, device=device)
        results["fpd"] = {"value": fpd_val, "error": fpd_err, "seconds": t1 - t0}
        results["kpd"] = {"value": kpd_val, "error": kpd_err,
                          "seconds": time.perf_counter() - t1}
        result = (
            f"FPD (x10^3): {fpd_val * 1e3:.4f} ± {fpd_err * 1e3:.4f}\n"
            f"KPD (x10^3): {kpd_val * 1e3:.4f} ± {kpd_err * 1e3:.4f}"
        )
        LOGGER.info(result)
        with open(
            os.path.join(arg.output_dir, f"fpd_kpd_{arg.dataset}.txt"), "w", encoding="utf-8"
        ) as f:
            f.write(result)
    return results

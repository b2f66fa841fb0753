"""Histogram and ratio-panel plots of the shower evaluation (port of
``vit4hep_tpu/evaluation/plots.py``).

One engine (:func:`ratio_panel`) draws the three-panel layout (normalised
histograms, model/reference ratio, |delta| in %), and each observable is a
thin wrapper that picks the data and the binning. The chi^2 separation
power (eq. 15 of arXiv:2009.03796) of each histogram is appended to
``histogram_chi2_{dataset}_{input_name}.txt``. matplotlib is imported
inside the functions that draw, so the module imports on hosts without it.
"""

from __future__ import annotations

import os

import numpy as np

from vit4hep_tpu_torch.utils.base_plots import pyplot

COLORS = ["#0000cc", "#cc0000", "#00cc00", "#cc00cc"]


def _pdf_pages(path):
    from matplotlib.backends.backend_pdf import PdfPages

    return PdfPages(path)


def separation_power(hist1, hist2, bins=None):
    """Triangular discrimination chi^2 (reference evaluate_plotting_helper.py:2705).

    Inputs must sum to 1; pass ``bins`` when they are densities instead.
    """
    if bins is not None:
        hist1 = hist1 * np.diff(bins)
        hist2 = hist2 * np.diff(bins)
    return 0.5 * float((((hist1 - hist2) ** 2) / (hist1 + hist2 + 1e-16)).sum())


def _steps(vals):
    """Duplicate the last bin value so step(where='post') closes the histogram."""
    return np.append(vals, vals[-1])


def ratio_panel(
    series,
    reference,
    bins,
    xlabel,
    labels,
    p_label="",
    x_scale="linear",
    pdf=None,
    filename=None,
    ref_label="Geant4",
):
    """One 3-panel figure: normalized histograms, model/reference ratio, |delta|%.

    ``series``: list of 1-D arrays (one per model); ``reference``: 1-D array.
    Returns the separation power of each series vs the reference.
    """
    plt = pyplot()
    counts_ref, bins = np.histogram(np.asarray(reference), bins=bins)
    with np.errstate(divide="ignore", invalid="ignore"):
        ref_norm = counts_ref / counts_ref.sum()
        ref_err = np.nan_to_num(ref_norm / np.sqrt(counts_ref))

    fig, ax = plt.subplots(
        3, 1, figsize=(5.0, 4.5),
        gridspec_kw={"height_ratios": (4, 1, 1), "hspace": 0.0}, sharex=True,
    )
    centers = 0.5 * (bins[:-1] + bins[1:])

    ax[0].step(bins, _steps(ref_norm), where="post", color="k", lw=1.0, alpha=0.8,
               label=ref_label)
    ax[0].fill_between(bins, _steps(ref_norm - ref_err), _steps(ref_norm + ref_err),
                       step="post", color="k", alpha=0.2)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.nan_to_num(ref_err / ref_norm)
    ax[1].fill_between(bins, _steps(1 - rel), _steps(1 + rel), step="post", color="k",
                       alpha=0.2)
    ax[2].errorbar(centers, np.zeros_like(centers), yerr=rel * 100, fmt=".",
                   color="grey", ecolor="grey", elinewidth=0.5, lw=1.0, capsize=2)

    seps = []
    for i, data in enumerate(series):
        counts, _ = np.histogram(np.asarray(data), bins=bins)
        with np.errstate(divide="ignore", invalid="ignore"):
            norm = counts / counts.sum()
            err = np.nan_to_num(norm / np.sqrt(counts))
            ratio = norm / ref_norm
            ratio_err = err / ref_norm
        bad = ~np.isfinite(ratio)
        ratio[bad], ratio_err[bad] = 1.0, 0.0
        c = COLORS[i % len(COLORS)]
        ax[0].step(bins, _steps(norm), where="post", color=c, lw=1.0, label=labels[i])
        ax[0].fill_between(bins, _steps(norm - err), _steps(norm + err), step="post",
                           color=c, alpha=0.2)
        ax[1].step(bins, _steps(ratio), where="post", color=c, lw=1.0)
        ax[1].fill_between(bins, _steps(ratio - ratio_err), _steps(ratio + ratio_err),
                           step="post", color=c, alpha=0.2)
        ax[2].errorbar(centers, np.abs(ratio - 1) * 100, yerr=ratio_err * 100, fmt=".",
                       color=c, ecolor=c, elinewidth=0.5, lw=1.0, capsize=2)
        seps.append(separation_power(ref_norm, norm))

    ax[0].set_yscale("log")
    ax[0].set_ylabel("a.u.")
    ax[0].legend(loc="best", frameon=False, title=p_label or None, handlelength=1.2)
    ax[1].axhline(1.0, color="k", lw=1.0, alpha=0.8)
    for y in (0.7, 1.3):
        ax[1].axhline(y, color="k", ls="--", lw=0.5)
    ax[1].set_yticks((0.7, 1.0, 1.3))
    ax[1].set_ylim(0.5, 1.5)
    ax[1].set_ylabel("Model/Ref")
    ax[2].set_yscale("log")
    ax[2].set_ylim(0.05, 50)
    ax[2].set_yticks([0.1, 1.0, 10.0])
    ax[2].axhline(1.0, lw=0.5, ls="--", color="grey")
    ax[2].set_ylabel(r"$\delta$ [%]")
    ax[2].set_xlabel(xlabel)
    if x_scale == "log":
        for a in ax:
            a.set_xscale("log")
    ax[0].set_xlim(bins[0], bins[-1])
    fig.tight_layout(pad=0.0, h_pad=0.0, w_pad=0.0, rect=(0.01, 0.01, 0.98, 0.98))
    if pdf is not None:
        pdf.savefig(fig, dpi=300)
    elif filename is not None:
        fig.savefig(filename, dpi=300)
    plt.close(fig)
    return seps


def _log_chi2(arg, input_name, text):
    path = os.path.join(arg.output_dir, f"histogram_chi2_{arg.dataset}_{input_name}.txt")
    with open(path, "a", encoding="utf-8") as f:
        f.write(text + "\n")


def _series_from(hlfs, getter, key=None):
    if key is None:
        return [getter(h) for h in hlfs]
    return [getter(h)[key] for h in hlfs]


def plot_Etot_Einc(hlfs, reference_class, arg, labels, input_names, p_label):
    """E_tot / E_inc, 30 bins on [0.5, 1.5] (reference :146-149)."""
    bins = np.linspace(0.5, 1.5, 31)
    seps = ratio_panel(
        [h.GetEtot() / h.Einc.squeeze() for h in hlfs],
        reference_class.GetEtot() / reference_class.Einc.squeeze(),
        bins, r"$E_{\mathrm{tot}} / E_{\mathrm{inc}}$", labels, p_label,
        filename=os.path.join(arg.output_dir, f"Etot_Einc_dataset_{arg.dataset}.pdf"),
    )
    for i, s in enumerate(seps):
        _log_chi2(arg, input_names[i], f"Etot/Einc: separation power = {s}")


def plot_Etot_Einc_discrete(hlf_class, reference_class, arg):
    """Per-incident-energy E_tot/E_inc histograms for ds1's discrete spectrum.

    4x4 grid, one panel per energy bin 2^8..2^22 MeV (reference
    evaluate_plotting_helper.py:75-143; defined upstream but never dispatched
    from evaluate.py — kept for API parity). Photons tighten the binning above
    the fourth energy point.
    """
    plt = pyplot()
    edges = 2.0 ** np.linspace(8, 23, 16)
    fig, axes = plt.subplots(4, 4, figsize=(10, 10))
    fig.subplots_adjust(wspace=0.3, hspace=0.3)
    handles, leg_labels = [], []
    for i in range(len(edges) - 1):
        if i > 3 and "photons" in arg.dataset:
            bins = np.linspace(0.9, 1.1, 21)
        else:
            bins = np.linspace(0.4, 1.4, 21)
        ax = axes.flat[i]
        energy = edges[i]
        seps_pair = []
        for cls, style in ((reference_class, "ref"), (hlf_class, "gen")):
            einc = np.asarray(cls.Einc).squeeze()
            sel = (einc >= edges[i]) & (einc < edges[i + 1])
            vals = np.asarray(cls.GetEtot())[sel] / einc[sel]
            counts, _ = np.histogram(vals, bins=bins)
            norm = counts / max(counts.sum(), 1)
            seps_pair.append(norm)
            if style == "ref":
                ax.stairs(norm, bins, fill=True, alpha=0.2, color="k",
                          label="reference")
            else:
                ax.stairs(norm, bins, color=COLORS[0], lw=1.5, label="generated")
        # panel-index thresholds as in the reference (:116-121): panels 0-2
        # label in MeV (so 2^10 prints "1024 MeV"), 3-11 GeV, 12+ TeV
        if i in (0, 1, 2):
            energy_label = f"E = {energy:.0f} MeV"
        elif i < 12:
            energy_label = f"E = {energy / 1e3:.1f} GeV"
        else:
            energy_label = f"E = {energy / 1e6:.1f} TeV"
        ax.text(0.95, 0.95, energy_label, ha="right", va="top",
                transform=ax.transAxes)
        ax.set_xlabel(r"$E_{\mathrm{tot}} / E_{\mathrm{inc}}$")
        ax.set_yticklabels([])
        handles, leg_labels = ax.get_legend_handles_labels()
        sep = separation_power(seps_pair[0], seps_pair[1])
        path = os.path.join(arg.output_dir, f"histogram_chi2_{arg.dataset}.txt")
        with open(path, "a", encoding="utf-8") as f:
            f.write(f"Etot / Einc at E = {energy}: \n{sep}\n\n")
    axes.flat[15].legend(handles, leg_labels, loc="center", fontsize=16)
    axes.flat[15].axis("off")
    fig.savefig(os.path.join(arg.output_dir,
                             f"Etot_Einc_dataset_{arg.dataset}_E_i.pdf"),
                dpi=300, format="pdf")
    plt.close(fig)


def plot_E_layers(hlfs, reference_class, arg, labels, input_names, p_label):
    """Per-layer deposited energy, log bins from min_energy (reference :522-541)."""
    path = os.path.join(arg.output_dir, f"E_layer_dataset_{arg.dataset}.pdf")
    with _pdf_pages(path) as pdf:
        for key in reference_class.GetElayers():
            ref = reference_class.GetElayers()[key]
            if arg.x_scale == "log":
                hi = 2 * arg.min_energy + np.nanmax(ref)
                bins = np.logspace(np.log10(arg.min_energy), np.log10(hi), 40)
            else:
                bins = 40
            seps = ratio_panel(
                _series_from(hlfs, lambda h: h.GetElayers(), key), ref, bins,
                f"$E_{{{key}}}$ [MeV]", labels, p_label, x_scale=arg.x_scale, pdf=pdf,
            )
            for i, s in enumerate(seps):
                _log_chi2(arg, input_names[i], f"E layer {key}: separation power = {s}")


def _ec_lim(reference_class, arg, key, getter_name, width=False):
    """Axis limits per dataset (reference :729-751, 940-954, 1151-1165,
    1364-1378). LEMURS derives each family's limits from ITS OWN observable
    (min/max +- 5), not from the eta centroids."""
    if arg.dataset in ("2", "3"):
        return (0.0, 30.0) if width else (-30.0, 30.0)
    if arg.dataset == "LEMURS":
        vals = getattr(reference_class, getter_name)().get(key)
        if vals is None:
            return (0.0, 100.0) if width else (-100.0, 100.0)
        return (vals.min() - 5.0, vals.max() + 5.0)
    if key in (12, 13):
        return (0.0, 400.0) if width else (-500.0, 500.0)
    return (0.0, 100.0) if width else (-100.0, 100.0)


def _plot_ec_family(hlfs, reference_class, arg, labels, input_names, p_label,
                    getter_name, tag, symbol, width=False):
    path = os.path.join(arg.output_dir, f"{tag}_layer_dataset_{arg.dataset}.pdf")
    with _pdf_pages(path) as pdf:
        ref_getter = getattr(reference_class, getter_name)
        for key in ref_getter():
            bins = np.linspace(
                *_ec_lim(reference_class, arg, key, getter_name, width), 51
            )
            seps = ratio_panel(
                [getattr(h, getter_name)()[key] for h in hlfs], ref_getter()[key],
                bins, f"{symbol} layer {key} [mm]", labels, p_label, pdf=pdf,
            )
            for i, s in enumerate(seps):
                _log_chi2(arg, input_names[i], f"{tag} layer {key}: separation power = {s}")


def plot_ECEtas(hlfs, reference_class, arg, labels, input_names, p_label):
    _plot_ec_family(hlfs, reference_class, arg, labels, input_names, p_label,
                    "GetECEtas", "ECEta", r"$\langle\eta\rangle$")


def plot_ECPhis(hlfs, reference_class, arg, labels, input_names, p_label):
    _plot_ec_family(hlfs, reference_class, arg, labels, input_names, p_label,
                    "GetECPhis", "ECPhi", r"$\langle\phi\rangle$")


def plot_ECWidthEtas(hlfs, reference_class, arg, labels, input_names, p_label):
    _plot_ec_family(hlfs, reference_class, arg, labels, input_names, p_label,
                    "GetWidthEtas", "WidthEta", r"$\sigma_{\eta}$", width=True)


def plot_ECWidthPhis(hlfs, reference_class, arg, labels, input_names, p_label):
    _plot_ec_family(hlfs, reference_class, arg, labels, input_names, p_label,
                    "GetWidthPhis", "WidthPhi", r"$\sigma_{\phi}$", width=True)


def plot_sparsity(hlfs, reference_class, arg, labels, input_names, p_label):
    """1 - sparsity per layer, 19 bins on [0, 1] (reference :2007-2020)."""
    path = os.path.join(arg.output_dir, f"Sparsity_layer_dataset_{arg.dataset}.pdf")
    with _pdf_pages(path) as pdf:
        for key in reference_class.GetSparsity():
            bins = np.linspace(0, 1, 20)
            seps = ratio_panel(
                [1 - h.GetSparsity()[key] for h in hlfs],
                1 - reference_class.GetSparsity()[key], bins,
                f"sparsity layer {key}", labels, p_label, pdf=pdf,
            )
            for i, s in enumerate(seps):
                _log_chi2(arg, input_names[i], f"Sparsity layer {key}: separation power = {s}")


def _plot_depth_family(hlfs, reference_hlf, arg, labels, input_names, p_label,
                       getter_name, tag, L=1):
    path = os.path.join(
        arg.output_dir, f"{tag}_dataset_{arg.dataset}_groups_{L}.pdf"
    )
    ref_prof = getattr(reference_hlf, getter_name)()
    if not ref_prof:
        return
    n_layers = len(reference_hlf.relevantLayers)
    keys = list(ref_prof.keys())
    per_group = max(1, len(keys) // L)
    with _pdf_pages(path) as pdf:
        for n, key in enumerate(keys):
            g = n // per_group
            bins = np.linspace(g * n_layers / L, (g + 1) * n_layers / L, 40)
            seps = ratio_panel(
                [getattr(h, getter_name)()[key] for h in hlfs], ref_prof[key], bins,
                f"{tag} {key}", labels, p_label, pdf=pdf,
            )
            for i, s in enumerate(seps):
                _log_chi2(arg, input_names[i], f"{tag} {key}: separation power = {s}")


def plot_weighted_depth_a(hlfs, reference_class, arg, labels, input_names, p_label, L=1):
    # NB the reference names this family "ring" (evaluate_plotting_helper.py:1796)
    _plot_depth_family(hlfs, reference_class, arg, labels, input_names, p_label,
                       "GetWeightedDepthA", "Weighted_Depth_ring", L)


def plot_weighted_depth_r(hlfs, reference_class, arg, labels, input_names, p_label, L=1):
    _plot_depth_family(hlfs, reference_class, arg, labels, input_names, p_label,
                       "GetWeightedDepthR", "Weighted_Depth_slice", L)


def plot_cell_dist(list_showers, ref_shower_arr, arg, labels, input_names, p_label):
    """Voxel-energy distribution over all layers (reference :2518-2535)."""
    ref = np.asarray(ref_shower_arr).ravel()
    if arg.x_scale == "log":
        bins = np.logspace(np.log10(arg.min_energy), np.log10(ref.max()), 50)
    else:
        bins = 50
    seps = ratio_panel(
        [np.asarray(s).ravel() for s in list_showers], ref, bins,
        r"$E_{\mathrm{voxel}}$ [MeV]", labels, p_label, x_scale=arg.x_scale,
        filename=os.path.join(arg.output_dir, f"voxel_energy_dataset_{arg.dataset}.pdf"),
    )
    for i, s in enumerate(seps):
        _log_chi2(arg, input_names[i], f"Voxel energy: separation power = {s}")


def plot_layer_comparison(hlf_class, data, reference_class, reference_data, arg,
                          input_name="", show=False):
    """Average generated vs reference shower, layer by layer (reference :30-73)."""
    plt = pyplot()
    path = os.path.join(
        arg.output_dir, f"Average_Layer_dataset_{arg.dataset}_{input_name}.pdf"
    )
    vmax = float(np.max(reference_data))
    boundaries = np.unique(reference_class.bin_edges)
    with _pdf_pages(path) as pdf:
        for idx, layer_id in enumerate(reference_class.relevantLayers):
            fig = plt.figure(figsize=(6, 4))
            reference_class._DrawSingleLayer(
                np.asarray(reference_data)[:, boundaries[idx] : boundaries[idx + 1]],
                idx, filename=None, title=f"Reference Layer {layer_id}", fig=fig,
                subplot=(1, 2, 1), vmax=vmax, colbar="None",
            )
            hlf_class._DrawSingleLayer(
                np.asarray(data)[:, boundaries[idx] : boundaries[idx + 1]],
                idx, filename=None, title=f"Generated Layer {layer_id}", fig=fig,
                subplot=(1, 2, 2), vmax=vmax, colbar="both",
            )
            pdf.savefig(fig, dpi=300)
            plt.close(fig)


def plot_Etot_Einc_scaled(hlfs, reference_class, arg, labels, input_names, p_label):
    """E_tot/E_inc with data-driven range (reference :333-345, LEMURS)."""
    ref_ratio = reference_class.GetEtot() / reference_class.Einc.squeeze()
    bins = np.linspace(np.quantile(ref_ratio, 0.001), ref_ratio.max() * 1.01, 31)
    seps = ratio_panel(
        [h.GetEtot() / h.Einc.squeeze() for h in hlfs], ref_ratio, bins,
        r"$E_{\mathrm{tot}} / E_{\mathrm{inc}}$", labels, p_label,
        filename=os.path.join(arg.output_dir, f"Etot_Einc_dataset_{arg.dataset}.pdf"),
    )
    for i, s in enumerate(seps):
        _log_chi2(arg, input_names[i], f"Etot/Einc (scaled): separation power = {s}")


def _profile_plot(hlfs, reference_class, arg, labels, getter_name, tag, xlabel,
                  input_names=(), chi2_tag=None):
    """Mean +- SEM energy profile across layer/radial indices with a ratio
    panel (reference :2209-2363). The separation power of the raw mean
    profiles is logged per model (reference :2318-2330)."""
    plt = pyplot()
    ref_prof = getattr(reference_class, getter_name)()
    if not ref_prof:
        return
    keys = list(ref_prof.keys())
    ref_means = np.array([ref_prof[k].mean() for k in keys])
    ref_sem = np.array(
        [ref_prof[k].std() / np.sqrt(len(ref_prof[k])) for k in keys]
    )
    fig, ax = plt.subplots(
        2, 1, figsize=(5.0, 4.5),
        gridspec_kw={"height_ratios": (3, 1), "hspace": 0.0}, sharex=True,
    )
    x = np.arange(len(keys) + 1)
    ax[0].step(x, _steps(ref_means), where="post", color="k", lw=1.0, label="Geant4")
    ax[0].fill_between(x, _steps(ref_means - ref_sem), _steps(ref_means + ref_sem),
                       step="post", color="k", alpha=0.2)
    for i, h in enumerate(hlfs):
        prof = getattr(h, getter_name)()
        means = np.array([prof[k].mean() for k in keys])
        sem = np.array([prof[k].std() / np.sqrt(len(prof[k])) for k in keys])
        c = COLORS[i % len(COLORS)]
        ax[0].step(x, _steps(means), where="post", color=c, lw=1.0, label=labels[i])
        ax[0].fill_between(x, _steps(means - sem), _steps(means + sem), step="post",
                           color=c, alpha=0.2)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.nan_to_num(means / ref_means, nan=1.0)
        ax[1].step(x, _steps(ratio), where="post", color=c, lw=1.0)
        if chi2_tag and i < len(input_names):
            s_pow = separation_power(ref_means, means)
            _log_chi2(arg, input_names[i],
                      f"{chi2_tag}: separation power = {s_pow}")
    ax[0].set_yscale("log")
    ax[0].set_ylabel("mean energy [MeV]")
    ax[0].legend(frameon=False)
    ax[1].axhline(1.0, color="k", lw=1.0)
    ax[1].set_ylim(0.5, 1.5)
    ax[1].set_ylabel("Model/Ref")
    ax[1].set_xlabel(xlabel)
    fig.tight_layout(pad=0.0, h_pad=0.0)
    fig.savefig(os.path.join(arg.output_dir, f"{tag}_dataset_{arg.dataset}.pdf"), dpi=300)
    plt.close(fig)


def plot_z_profile(hlfs, reference_class, arg, labels, input_names, p_label):
    _profile_plot(hlfs, reference_class, arg, labels, "GetElayers",
                  "profile_energy_z", "layer index",
                  input_names=input_names, chi2_tag="z profile")


def plot_r_profile(hlfs, reference_class, arg, labels, input_names, p_label):
    _profile_plot(hlfs, reference_class, arg, labels, "GetEradial",
                  "profile_energy_r", "radial index",
                  input_names=input_names, chi2_tag="r profile")


def plot_conditions(sample_conds, ref_conds, arg, labels, input_names, p_label):
    """Histograms of the sampling conditions (reference lemurs/evaluate.py:100)."""
    path = os.path.join(arg.output_dir, "conditions.pdf")
    names = ["E_inc [MeV]", "theta", "phi"]
    with _pdf_pages(path) as pdf:
        for n in range(sample_conds.shape[1]):
            both = np.concatenate([sample_conds[:, n], ref_conds[:, n]])
            bins = np.linspace(both.min() - 1, both.max() + 1, 41)
            ratio_panel(
                [sample_conds[:, n]], ref_conds[:, n], bins,
                names[n] if n < len(names) else f"cond {n}", labels, p_label, pdf=pdf,
            )

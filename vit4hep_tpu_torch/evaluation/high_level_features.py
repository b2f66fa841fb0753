"""Physics observables ("high-level features") of calorimeter showers (port
of ``vit4hep_tpu/evaluation/high_level_features.py``, numpy on the host).

Total and per-layer energies, sparsity, centres of energy and their widths
in eta/phi, energy-weighted depth profiles (per radial and angular slice,
optionally in groups of layers) and radial energy profiles; and the
polar-grid shower images (``DrawAverageShower``, ``DrawSingleShower``),
which import matplotlib only when they draw. The accessors (``GetEtot``,
``GetElayers``, ...) return dicts keyed by layer id.
"""

from __future__ import annotations

import os

import numpy as np

from vit4hep_tpu_torch.data.xml_handler import XMLHandler
from vit4hep_tpu_torch.utils.base_plots import pyplot


class HighLevelFeatures:
    """Observables for one detector geometry parsed from ``binning.xml``."""

    def __init__(self, particle, filename="binning.xml"):
        xml = XMLHandler(particle, filename=filename)
        self.particle = particle
        self.bin_edges = xml.GetBinEdges()
        self.eta_all_layers, self.phi_all_layers = xml.GetEtaPhiAllLayers()
        self.relevantLayers = xml.GetRelevantLayers()
        self.layersBinnedInAlpha = xml.GetLayersWithBinningInAlpha()
        # r-edges / alpha-bin counts of the *relevant* layers only
        self.r_edges = [e for e in xml.r_edges if len(e) > 1]
        self.num_alpha = [
            xml.a_bins[i] for i, e in enumerate(xml.r_edges) if len(e) > 1
        ]
        self.num_voxel = [
            (len(e) - 1) * a for e, a in zip(self.r_edges, self.num_alpha)
        ]

        self.Einc = None
        self.E_tot = None
        self.E_layers = {}
        self.EC_etas = {}
        self.EC_phis = {}
        self.width_etas = {}
        self.width_phis = {}
        self.sparsity = {}
        self.weighted_depth_a = {}
        self.weighted_depth_r = {}
        self.weighted_depth_ga = {}
        self.weighted_depth_gr = {}
        self.Eradial = {}

    # -- helpers ---------------------------------------------------------------
    def _layer_slice(self, data, layer_id):
        return data[:, self.bin_edges[layer_id] : self.bin_edges[layer_id + 1]]

    def _layer_grid(self, data, idx, layer_id):
        """Layer voxels reshaped to (events, n_alpha, n_r); flat order is
        alpha-major within a layer."""
        n_r = len(self.r_edges[idx]) - 1
        return self._layer_slice(data, layer_id).reshape(len(data), self.num_alpha[idx], n_r)

    @staticmethod
    def _center_and_width(pos, energy):
        """Energy-weighted first/second moments of voxel positions."""
        e_sum = energy.sum(axis=-1) + 1e-16
        mean = (pos * energy).sum(axis=-1) / e_sum
        second = (pos * pos * energy).sum(axis=-1) / e_sum
        width = np.sqrt(np.clip(second - mean**2, 0.0, None))
        return mean, width

    def GetECandWidths(self, eta_layer, phi_layer, energy_layer):
        """Centers of energy in eta/phi and their widths (reference
        HighLevelFeatures.py:73-81)."""
        eta_ec, eta_w = self._center_and_width(np.asarray(eta_layer), energy_layer)
        phi_ec, phi_w = self._center_and_width(np.asarray(phi_layer), energy_layer)
        return eta_ec, phi_ec, eta_w, phi_w

    # -- depth / radial profiles -------------------------------------------------
    def _depth_profile(self, data, axis, group=slice(None)):
        """Energy-weighted mean layer index, restricted to one radial bin
        (axis='r', one profile per r-index) or one angular bin (axis='a').

        Returns array (events, n_bins_along_axis). ``group`` restricts the sum
        to a contiguous subset of the relevant layers.
        """
        layers = np.asarray(self.relevantLayers)[group]
        # stack per-layer (events, n_alpha, n_r) grids -> (L, B, A, R)
        grids = np.stack(
            [self._layer_grid(data, self.relevantLayers.index(L), L) for L in layers]
        )
        if axis == "r":
            # profile per radial index: sum over alpha
            e = grids.sum(axis=2)  # (L, B, R)
        else:
            # profile per angular index: sum over r
            e = grids.sum(axis=3)  # (L, B, A)
        w = np.asarray(layers, dtype=np.float64)[:, None, None]
        num = (e * w).sum(axis=0)
        den = e.sum(axis=0) + 1e-8
        return num / den  # (events, n_bins_along_axis)

    def GetWeightedDepths(self, data):
        n_r = len(self.r_edges[0]) - 1
        prof_r = self._depth_profile(data, "r")  # (events, n_r)
        for n in range(n_r):
            self.weighted_depth_a[n] = prof_r[:, n]
        prof_a = self._depth_profile(data, "a")
        for n in range(self.num_alpha[0]):
            self.weighted_depth_r[n] = prof_a[:, n]

    def GetGroupedWeightedDepths(self, data, L=5):
        """Depth profiles within groups of L consecutive layers (reference
        HighLevelFeatures.py:129-145)."""
        n_layers = len(self.relevantLayers)
        n_groups = int(n_layers / L)
        if n_groups < 1:
            return
        frac = int(n_layers / n_groups)
        n_r = len(self.r_edges[0]) - 1
        j = 0
        for k in range(n_groups):
            prof = self._depth_profile(data, "r", slice(k * frac, (k + 1) * frac))
            for n in range(n_r):
                self.weighted_depth_ga[j] = prof[:, n]
                j += 1
        j = 0
        for k in range(n_groups):
            prof = self._depth_profile(data, "a", slice(k * frac, (k + 1) * frac))
            for n in range(self.num_alpha[0]):
                self.weighted_depth_gr[j] = prof[:, n]
                j += 1

    def CalculateEradial(self, data):
        """Total energy per radial index, summed over layers and angles."""
        n_r = len(self.r_edges[0]) - 1
        total = np.zeros((n_r, len(data)))
        for idx, layer_id in enumerate(self.relevantLayers):
            grid = self._layer_grid(data, idx, layer_id)  # (B, A, R)
            r_here = grid.shape[-1]
            total[:r_here] += grid.sum(axis=1).T
        for n in range(n_r):
            self.Eradial[n] = total[n]

    # -- main entry ---------------------------------------------------------------
    def CalculateFeatures(self, data):
        data = np.asarray(data)
        self.E_tot = data.sum(axis=-1)
        for idx, L in enumerate(self.relevantLayers):
            layer = self._layer_slice(data, L)
            self.E_layers[L] = layer.sum(axis=-1)
            self.sparsity[L] = (layer > 0).mean(axis=1)
            if L in self.layersBinnedInAlpha:
                (
                    self.EC_etas[L],
                    self.EC_phis[L],
                    self.width_etas[L],
                    self.width_phis[L],
                ) = self.GetECandWidths(
                    self.eta_all_layers[L], self.phi_all_layers[L], layer
                )
        uniform = all(len(e) == len(self.r_edges[0]) for e in self.r_edges) and all(
            a == self.num_alpha[0] for a in self.num_alpha
        )
        if uniform:
            self.GetWeightedDepths(data)
            self.GetGroupedWeightedDepths(data)
            self.CalculateEradial(data)

    # -- accessor surface (reference-compatible) -----------------------------------
    def GetEtot(self):
        return self.E_tot

    def GetElayers(self):
        return self.E_layers

    def GetECEtas(self):
        return self.EC_etas

    def GetECPhis(self):
        return self.EC_phis

    def GetWidthEtas(self):
        return self.width_etas

    def GetWidthPhis(self):
        return self.width_phis

    def GetSparsity(self):
        return self.sparsity

    def GetWeightedDepthA(self):
        return self.weighted_depth_a

    def GetWeightedDepthR(self):
        return self.weighted_depth_r

    def GetGroupedWeightedDepthA(self):
        return self.weighted_depth_ga

    def GetGroupedWeightedDepthR(self):
        return self.weighted_depth_gr

    def GetEradial(self):
        return self.Eradial

    # -- shower rendering -----------------------------------------------------------
    def _polar_panel(self, ax, voxels, idx, vmax):
        """Render one layer's (flat, alpha-major) voxels on a polar grid."""
        from matplotlib.colors import LogNorm

        pyplot()

        n_splits = 400
        radii = np.array(self.r_edges[idx], dtype=float)
        if self.particle != "electron":
            radii[1:] = np.log(radii[1:])
        theta, rad = np.meshgrid(
            2.0 * np.pi * np.arange(n_splits + 1) / n_splits, radii
        )
        reps = n_splits // self.num_alpha[idx]
        img = np.repeat(voxels.reshape(self.num_alpha[idx], -1), reps, axis=0)
        ax.grid(False)
        pcm = ax.pcolormesh(theta, rad, img.T + 1e-16, norm=LogNorm(vmin=1e-2, vmax=vmax))
        pcm.set_edgecolor("face")
        ax.xaxis.set_visible(False)
        ax.yaxis.set_visible(False)
        max_r = max(e[-1] for e in self.r_edges)
        ax.set_rmax(max_r if self.particle == "electron" else np.log(max_r))
        return pcm

    def _DrawSingleLayer(
        self, data, layer_nr, filename, title=None, fig=None, subplot=(1, 1, 1),
        vmax=None, colbar="alone",
    ):
        plt = pyplot()
        if fig is None:
            fig = plt.figure(figsize=(2, 2), dpi=200)
        ax = fig.add_subplot(*subplot, polar=True)
        flat = np.asarray(data).mean(axis=0) if np.asarray(data).ndim == 2 else np.asarray(data)
        pcm = self._polar_panel(ax, flat, layer_nr, vmax if vmax is not None else flat.max())
        if title is not None:
            ax.set_title(title, fontsize=8)
        if colbar != "None":
            fig.colorbar(pcm, ax=ax, fraction=0.15, orientation="horizontal", label="Energy (MeV)")
        if filename is not None:
            fig.savefig(filename, facecolor="white")

    def _DrawShower(self, data, filename, title):
        plt = pyplot()
        n = len(self.relevantLayers)
        ncols = 5 if self.particle == "electron" else n
        nrows = int(np.ceil(n / ncols))
        fig = plt.figure(figsize=(2 * ncols, 2.4 * nrows), dpi=150)
        boundaries = np.unique(self.bin_edges)
        vmax = max(float(np.max(data)), 1e-2)
        pcm = None
        for idx, layer_id in enumerate(self.relevantLayers):
            ax = fig.add_subplot(nrows, ncols, idx + 1, polar=True)
            pcm = self._polar_panel(
                ax, np.asarray(data)[boundaries[idx] : boundaries[idx + 1]], idx, vmax
            )
            ax.set_title(f"Layer {layer_id}", fontsize=8)
        if pcm is not None:
            fig.colorbar(
                pcm, ax=fig.get_axes(), fraction=0.05, orientation="horizontal",
                label="Energy (MeV)",
            )
        if title is not None:
            fig.suptitle(title)
        if filename is not None:
            fig.savefig(filename, facecolor="white")
        plt.close(fig)

    def DrawAverageShower(self, data, filename=None, title=None):
        self._DrawShower(np.asarray(data).mean(axis=0), filename=filename, title=title)

    def DrawSingleShower(self, data, filename=None, title=None):
        data = np.atleast_2d(np.asarray(data))
        for num, shower in enumerate(data):
            name = None
            if filename is not None:
                base, ext = os.path.splitext(filename)
                name = f"{base}_{num}{ext}"
            self._DrawShower(shower, filename=name, title=title)

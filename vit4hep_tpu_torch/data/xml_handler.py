"""CaloChallenge ``binning.xml`` geometry parser (port of
``vit4hep_tpu/data/xml_handler.py``).

Each ``<Layer>`` of the chosen ``<Particle>`` has ``r_edges`` and
``n_bin_alpha``; a layer holds ``n_r * n_alpha`` voxels and layers are
concatenated in file order. Within a layer the flat voxel index runs
alpha-major: ``flat = alpha_bin * n_r + r_bin``. Besides the voxel counts
and flat bin edges that the transforms read, the parser keeps each layer's
radial edges, alpha-bin count and bin centres, and the per-voxel cartesian
(eta, phi) positions that the evaluation's high-level features read.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np


@dataclass
class LayerBinning:
    layer_id: int
    r_edges: np.ndarray  # (n_r + 1,)
    n_alpha: int

    @property
    def n_r(self) -> int:
        return len(self.r_edges) - 1

    @property
    def n_bins(self) -> int:
        return self.n_r * self.n_alpha

    @property
    def r_mid(self) -> np.ndarray:
        return 0.5 * (self.r_edges[:-1] + self.r_edges[1:])

    @property
    def alpha_mid(self) -> np.ndarray:
        edges = np.linspace(-math.pi, math.pi, self.n_alpha + 1)
        return 0.5 * (edges[:-1] + edges[1:])


class XMLHandler:
    """Parsed calorimeter geometry of one particle type."""

    def __init__(self, particle_name: str, filename: str = "binning.xml"):
        self.particle_name = particle_name
        self.filename = filename
        root = ET.parse(filename).getroot()
        particle = next((node for node in root if node.attrib.get("name") == particle_name),
                        None)
        if particle is None:
            raise ValueError(f"Particle {particle_name} not found in {filename}")
        self.layers = [
            LayerBinning(layer_id=int(node.attrib["id"]),
                         r_edges=np.array([float(s) for s in node.attrib["r_edges"].split(",")]),
                         n_alpha=int(node.attrib["n_bin_alpha"]))
            for node in particle]
        self.bin_number = [layer.n_bins for layer in self.layers]
        self.totalBins = int(sum(self.bin_number))
        self.bin_edges = np.concatenate([[0], np.cumsum(self.bin_number)]).astype(int)
        self.relevantlayers = [i for i, lyr in enumerate(self.layers) if lyr.n_r > 0]
        self.layerWithBinningInAlpha = [lyr.layer_id for lyr in self.layers if lyr.n_alpha > 1]
        self.r_edges = [list(lyr.r_edges) for lyr in self.layers]
        self.a_bins = [lyr.n_alpha for lyr in self.layers]
        self.r_bins = [lyr.n_r for lyr in self.layers]
        self.eta_all_layers, self.phi_all_layers = self._voxel_eta_phi()

    def _voxel_eta_phi(self):
        """Per-voxel cartesian positions of each layer, alpha-major."""
        etas, phis = [], []
        for lyr in self.layers:
            if lyr.n_r == 0:
                etas.append(np.zeros(0))
                phis.append(np.zeros(0))
                continue
            r = np.tile(lyr.r_mid, lyr.n_alpha)
            a = np.repeat(lyr.alpha_mid, lyr.n_r)
            etas.append(r * np.cos(a))
            phis.append(r * np.sin(a))
        return etas, phis

    def GetTotalNumberOfBins(self):
        return self.totalBins

    def GetBinEdges(self):
        return self.bin_edges

    def GetEtaPhiAllLayers(self):
        return self.eta_all_layers, self.phi_all_layers

    def GetRelevantLayers(self):
        return self.relevantlayers

    def GetLayersWithBinningInAlpha(self):
        return self.layerWithBinningInAlpha

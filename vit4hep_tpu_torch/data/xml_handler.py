"""CaloChallenge ``binning.xml`` geometry parser (port of the part of
``vit4hep_tpu/data/xml_handler.py`` that the serving transforms read).

Each ``<Layer>`` of the chosen ``<Particle>`` has ``r_edges`` and
``n_bin_alpha``; a layer holds ``n_r * n_alpha`` voxels and layers are
concatenated in file order. The per-voxel (eta, phi) positions that the
evaluation code reads are not ported yet.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np


class XMLHandler:
    """Voxel counts and flat bin edges of one particle's calorimeter layers."""

    def __init__(self, particle_name: str, filename: str = "binning.xml"):
        self.particle_name = particle_name
        self.filename = filename
        root = ET.parse(filename).getroot()
        particle = next((node for node in root if node.attrib.get("name") == particle_name),
                        None)
        if particle is None:
            raise ValueError(f"Particle {particle_name} not found in {filename}")
        self.r_bins = [len(layer.attrib["r_edges"].split(",")) - 1 for layer in particle]
        self.a_bins = [int(layer.attrib["n_bin_alpha"]) for layer in particle]
        self.bin_number = [r * a for r, a in zip(self.r_bins, self.a_bins)]
        self.totalBins = int(sum(self.bin_number))
        self.bin_edges = np.concatenate([[0], np.cumsum(self.bin_number)]).astype(int)

    def GetTotalNumberOfBins(self):
        return self.totalBins

    def GetBinEdges(self):
        return self.bin_edges

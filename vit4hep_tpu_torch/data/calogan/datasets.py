"""CaloGAN dataset (port of ``vit4hep_tpu/data/calogan/datasets.py``):
three calorimeter layers (288 + 144 + 72 voxels, GeV after the 1e3 scaling)
and the incident energy, flattened and preprocessed once at construction
into host arrays. h5py is imported inside :func:`load_data`."""

from __future__ import annotations

import numpy as np

from vit4hep_tpu_torch.utils.logger import LOGGER


def load_data(data_file):
    """``layer_0/1/2`` (scaled to GeV) and ``energy`` of a CaloGAN file."""
    import h5py  # host-side reader; the card's machine has none

    with h5py.File(data_file, "r") as f:
        return {
            "layer_0": f["layer_0"][:] / 1e3,
            "layer_1": f["layer_1"][:] / 1e3,
            "layer_2": f["layer_2"][:] / 1e3,
            "energy": f["energy"][:] / 1e0,
        }


class CaloGANDataset:
    """Eagerly preprocessed CaloGAN showers: ``return_us=True`` holds
    (u-vectors, energy) for the energy model, else (flat 504-voxel showers
    with a channel axis, [energy, u's]). ``data``, the dict
    :func:`load_data` returns, stands in for reading ``hdf5_file``."""

    bin_edges = np.array([0, 288, 432, 504])

    def __init__(self, hdf5_file, transform=None, return_us=False, rank=0, data=None):
        data = load_data(hdf5_file) if data is None else dict(data)
        for key in data:
            data[key] = np.asarray(data[key], np.float32).reshape(len(data[key]), -1)
        for fn in transform or ():
            if fn.__class__.__name__ == "NormalizeLayerEnergyGAN":
                fn.bin_edges = self.bin_edges
            data = fn(data, rank=rank)
        if return_us:
            self.layers = data["extra_dims"]
            self.energy = data["energy"]
        else:
            self.layers = np.concatenate([data["layer_0"], data["layer_1"], data["layer_2"]],
                                         axis=1)[:, None, :]
            self.energy = np.concatenate([data["energy"], data["extra_dims"]], axis=1)
        self.layers = self.layers.astype(np.float32)
        self.energy = self.energy.astype(np.float32)
        LOGGER.info(f"datasets: loaded data with shape {self.layers.shape}")
        LOGGER.info(f"datasets: boundaries of dataset are ({self.layers.min()}, "
                    f"{self.layers.max()})")

    def __len__(self):
        return len(self.energy)

"""CaloChallenge dataset: eager HDF5 load + one-shot preprocessing on the host
(port of ``vit4hep_tpu/data/calochallenge/datasets.py``).

Showers are loaded layer-sliced from HDF5, the whole transform chain is
applied once at construction, and the train/validation splits are taken by
fraction. Batches are numpy arrays; the training loop moves them to the
device. ``h5py`` is imported inside :func:`load_data`, so the module imports
on hosts without it.
"""

from __future__ import annotations

import numpy as np

from vit4hep_tpu_torch.data.xml_handler import XMLHandler
from vit4hep_tpu_torch.utils.logger import LOGGER


def load_data(filename, particle_type, xml_filename):
    """Incident energies (N, 1) and layer-sorted flat showers (MeV)."""
    import h5py  # host-side reader; the card's machine has none

    xml = XMLHandler(particle_type, xml_filename)
    layer_boundaries = np.unique(xml.GetBinEdges())
    with h5py.File(filename, "r") as f:
        energy = f["incident_energies"][:].reshape(-1, 1)
        showers = f["showers"][:]
    layers = np.concatenate(
        [showers[..., s:e] for s, e in zip(layer_boundaries[:-1], layer_boundaries[1:])], axis=1)
    return energy, layers, layer_boundaries


def split_arrays(layers, energy, split, train_val_frac):
    """The rows of one split: training is the head, validation the tail; the
    validation split keeps at least one event, and the training split never
    overlaps it."""
    n = len(energy)
    trn_size = int(n * train_val_frac[0])
    val_floor = max(1, int(n * train_val_frac[1]))
    if split == "training":
        trn_size = min(trn_size, n - val_floor)
        return layers[:trn_size], energy[:trn_size]
    if split == "validation":
        return layers[-val_floor:], energy[-val_floor:]
    return layers, energy


class CaloChallengeDataset:
    """In-RAM dataset of (shower, cond) with the transform chain pre-applied."""

    def __init__(self, hdf5_file, particle_type, xml_filename, train_val_frac=(0.7, 0.3),
                 transform=None, split="full", dtype=np.float32, rank=0, arrays=None):
        """``arrays``: (energy (N, 1), layers (N, V), layer_boundaries) in
        place of reading ``hdf5_file``."""
        if split != "full" and train_val_frac[0] + train_val_frac[1] > 1.0:
            raise ValueError(f"train_val_frac {train_val_frac} adds up to more than 1")
        energy, layers, self.layer_boundaries = (
            load_data(hdf5_file, particle_type, xml_filename) if arrays is None else arrays)
        self.energy = energy.astype(dtype)
        self.layers = layers.astype(dtype)
        for fn in transform or ():
            self.layers, self.energy = fn(self.layers, self.energy, rank=rank)
        self.layers, self.energy = split_arrays(self.layers, self.energy, split, train_val_frac)
        self.layers = np.ascontiguousarray(self.layers, dtype=dtype)
        self.energy = np.ascontiguousarray(self.energy, dtype=dtype)
        LOGGER.info(f"datasets: loaded {split} data with shape {self.layers.shape}")
        LOGGER.info(f"datasets: boundaries of dataset are ({self.layers.min()}, "
                    f"{self.layers.max()})")

    def __len__(self):
        return len(self.energy)

    def __getitem__(self, idx):
        return self.layers[idx], self.energy[idx]


class BatchIterator:
    """Infinite shuffled stream of fixed-size batches over host arrays; the
    remainder of each epoch is dropped."""

    def __init__(self, arrays, batch_size: int, seed: int = 0, shuffle: bool = True):
        self.arrays = arrays
        self.batch_size = int(batch_size)
        self.n = len(arrays[0])
        if self.n < self.batch_size:
            raise ValueError(f"dataset of {self.n} samples < batch size {self.batch_size}")
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle
        self.batches_per_epoch = self.n // self.batch_size
        self._epoch_order = None
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._epoch_order is None or self._pos >= self.batches_per_epoch:
            self._epoch_order = self.rng.permutation(self.n) if self.shuffle else np.arange(self.n)
            self._pos = 0
        idx = self._epoch_order[self._pos * self.batch_size:(self._pos + 1) * self.batch_size]
        self._pos += 1
        return tuple(a[idx] for a in self.arrays)

    def epoch_batches(self):
        """One full epoch of fixed-size batches, in order (for validation)."""
        for i in range(self.batches_per_epoch):
            yield tuple(a[i * self.batch_size:(i + 1) * self.batch_size] for a in self.arrays)

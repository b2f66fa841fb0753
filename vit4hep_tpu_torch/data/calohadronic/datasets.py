"""CaloHadronic's (ECal + HCal) data pipeline (port of
``vit4hep_tpu/data/calohadronic/datasets.py``): LEMURS's lazy multi-file
HDF5 reader and prefetching iterator over events with ``energy`` (GeV),
``ecal`` (raw 30x180x180, downsampled by the transform pipeline) and
``hcal`` (48x30x30). The collator concatenates the flattened calorimeters
into one (B, 1, 45450) shower and builds the [u's, energy(, additional
conditions)] condition vector."""

from __future__ import annotations

import numpy as np

from vit4hep_tpu_torch.data.lemurs.datasets import (  # noqa: F401
    ArrayEvents, CollatedBatchIterator, LEMURSDataset, read_first_file)

FIELDS = ("energy", "ecal", "hcal")


def load_data(hdf5_file, local_index=None, dtype="float32"):
    """energy (n, 1), ecal and hcal of an open file's ``events`` table."""
    slicer = local_index if local_index is not None else slice(None)
    event = hdf5_file["events"][slicer]
    data = {key: np.asarray(event[key], dtype) for key in FIELDS}
    if local_index is not None and np.isscalar(local_index):
        data = {k: v[None] for k, v in data.items()}
    if data["energy"].ndim == 1:
        data["energy"] = data["energy"][:, None]
    return data


class CaloHadDataset(LEMURSDataset):
    """LEMURSDataset's index map and handle cache over the CaloHadronic
    event files; one class."""

    def _read_rows(self, handle, rows):
        event = handle["events"][rows]
        return {"energy": np.asarray(event["energy"], self.dtype).reshape(len(rows), -1),
                "ecal": np.asarray(event["ecal"], self.dtype),
                "hcal": np.asarray(event["hcal"], self.dtype)}

    def read_indices(self, indices):
        data, _ = super().read_indices(indices)
        return data, np.zeros(len(indices), np.int32)


class CaloHadCollator:
    """The transform pipeline on each batch: (u's, energy) for an energy
    model, else (flat ECal + HCal shower, [u's, energy(, additional
    conditions)]). The file-backed transform state is fitted at
    construction on ``warmup`` (a dict as :func:`load_data` returns), by
    default every event of the first training file."""

    def __init__(self, hdf5_train_dict, transforms, return_us=False, rank=0, dtype="float32",
                 warmup=None):
        self.transforms = transforms
        self.return_us = bool(return_us)
        self.rank = rank
        if self.transforms:
            dummy = read_first_file(hdf5_train_dict, load_data, dtype) if warmup is None \
                else dict(warmup)
            for fn in self.transforms:
                dummy = fn(dummy, rank=self.rank)

    def __call__(self, batch_dict, _class_indices):
        batch_dict = dict(batch_dict)
        for fn in self.transforms or ():
            batch_dict = fn(batch_dict)
        if self.return_us:
            us = batch_dict.pop("extra_dims")
            return np.asarray(us, np.float32), np.asarray(batch_dict["energy"], np.float32)
        shower = np.concatenate([batch_dict.pop("ecal"), batch_dict.pop("hcal")], axis=2)
        conds = np.concatenate([batch_dict["extra_dims"], batch_dict["energy"]], axis=-1)
        if batch_dict.get("additional_conds") is not None:
            conds = np.concatenate([conds, batch_dict["additional_conds"]], axis=-1)
        return np.asarray(shower, np.float32), np.asarray(conds, np.float32)

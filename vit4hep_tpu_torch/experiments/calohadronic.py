"""CaloHadronic experiment (port of
``vit4hep_tpu/experiments/calohadronic.py``): joint ECal + HCal pion
showers, E_inc ~ U(10, 90) GeV, LEMURS's lazy multi-file pipeline, and the
u-space or feature-classifier evaluation (``evaluation/calohadronic.py``).
The shape model's condition is ``[u | E]``. The readers are methods
(:meth:`CaloHadronic.open_events`, :meth:`CaloHadronic.warmup_events`), so
that a subclass can hand in events.
"""

from __future__ import annotations

import numpy as np

from vit4hep_tpu_torch.data.calohadronic.datasets import (CaloHadCollator, CaloHadDataset,
                                                           load_data)
from vit4hep_tpu_torch.data.calohadronic.transforms import build_pipeline
from vit4hep_tpu_torch.experiments.families import LazyFamilyExperiment

ECAL_SHAPE = (10, 15, 15)
HCAL_SHAPE = (48, 30, 30)


class CaloHadronic(LazyFamilyExperiment):
    pipeline = staticmethod(build_pipeline)
    load_data = staticmethod(load_data)
    ratio_step = "CaloHadNormalizeByElayer"
    evaluation = "vit4hep_tpu_torch.evaluation.calohadronic"
    sample_keys = ("ecal", "hcal", "energy")

    def init_data(self):
        self.hdf5_dict_train = {k: list(v) for k, v in self.cfg.data.training_file_dict.items()}
        self.hdf5_dict_test = {k: list(v) for k, v in self.cfg.data.test_file_dict.items()}
        self.max_files_per_worker = int(self.cfg.data.max_files_per_worker)
        self.return_us = bool(self.cfg.data.return_us)
        self.transforms = self.build_transforms(self.cfg.data.transforms, self.cfg.run_dir)
        self._log_transforms()
        self.train_dataset = self.open_events(self.hdf5_dict_train)
        self.val_dataset = self.open_events(self.hdf5_dict_test)

    def open_events(self, files_dict):
        """The lazy dataset over one split's files."""
        return CaloHadDataset(files_dict, max_files_per_worker=self.max_files_per_worker)

    def collator(self, files_dict, return_us):
        return CaloHadCollator(hdf5_train_dict=files_dict, transforms=self.transforms,
                               return_us=return_us, rank=self.rank,
                               warmup=self.warmup_events(files_dict))

    # ------------------------------------------------------------------ sampling
    def draw_conditions(self, n, rng):
        """Incident energies ~ U(10, 90) GeV, (n, 1)."""
        return rng.uniform(10, 90, size=(n, 1)).astype(np.float32)

    def sampling_conditions(self, e_inc):
        return self.forward_conditions({"energy": np.asarray(e_inc, np.float32)})["energy"]

    def truth_conditions(self):
        return np.concatenate([c for _, c in self._test_batches(False)], axis=0)

    # ------------------------------------------------------------------ plot/eval
    def to_showers(self, samples, conditions):
        """Shape samples (B, 1, 45450) in the training basis -> the dict of
        GeV ``ecal`` (B, 10, 15, 15) and ``hcal`` (B, 48, 30, 30), u's and
        incident energies, every transform reversed."""
        samples = samples[:, 0]
        n_ecal, n_hcal = int(np.prod(ECAL_SHAPE)), int(np.prod(HCAL_SHAPE))
        n_layers = ECAL_SHAPE[0] + HCAL_SHAPE[0]
        data = {"ecal": samples[:, :n_ecal].reshape(-1, *ECAL_SHAPE),
                "hcal": samples[:, -n_hcal:].reshape(-1, *HCAL_SHAPE),
                "extra_dims": conditions[:, :n_layers],
                "energy": conditions[:, n_layers:n_layers + 1]}
        for fn in self.transforms[::-1]:
            data = fn(data, rev=True)
        return data

    def u_dict(self, us, conds):
        return {"extra_dims": us, "energy": conds[:, :1]}

    def energy_eval_inputs(self, samples_u, conditions, reference_u, reference_conds):
        """The u's alone."""
        return samples_u, reference_u

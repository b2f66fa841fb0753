"""CaloGAN experiment (port of ``vit4hep_tpu/experiments/calogan.py``).

Trains a CFM energy or shape model on the three-layer CaloGAN dataset with
its dict-protocol transforms, samples with E_inc ~ U(1, 100) GeV, and
evaluates with the low-level DNN classifier (``evaluation/calogan.py``) or,
for an energy model, the u-space suite. The two-stage chain's condition is
``[E | u]`` (``u_position = "last"``). The file reader is a method
(:meth:`CaloGAN.load_showers`), so that a subclass can hand in events.
"""

from __future__ import annotations

import warnings

import numpy as np

from vit4hep_tpu_torch.data.calogan.datasets import CaloGANDataset, load_data
from vit4hep_tpu_torch.data.calogan.transforms import LAYER_KEYS, build_pipeline
from vit4hep_tpu_torch.data.pipeline import reverse_until
from vit4hep_tpu_torch.experiments.families import DictFamilyExperiment, clipped_ratios
from vit4hep_tpu_torch.utils.logger import LOGGER


class CaloGAN(DictFamilyExperiment):
    pipeline = staticmethod(build_pipeline)
    u_position = "last"

    def init_data(self):
        self.hdf5_train = self.cfg.data.training_file
        self.hdf5_test = self.cfg.data.test_file
        self.return_us = bool(self.cfg.data.return_us)
        self.transforms = self.build_transforms(self.cfg.data.transforms, self.cfg.run_dir)
        self._log_transforms()
        self.train_dataset = CaloGANDataset(self.hdf5_train, transform=self.transforms,
                                            return_us=self.return_us, rank=self.rank,
                                            data=self.load_showers())
        # the reference validates on the training file
        self.val_dataset = self.train_dataset
        self.layer_boundaries = self.train_dataset.bin_edges

    def load_showers(self):
        """The training file's layers (GeV) and energies, as
        ``data/calogan/datasets.load_data`` gives them."""
        return load_data(self.hdf5_train)

    def load_test_showers(self):
        return load_data(self.hdf5_test)

    def test_dataset(self):
        return CaloGANDataset(self.hdf5_test, transform=self.transforms,
                              return_us=self.return_us, data=self.load_test_showers())

    # ------------------------------------------------------------------ sampling
    def draw_conditions(self, n, rng):
        """Incident energies ~ U(1, 100) GeV, (n, 1)."""
        return (rng.random((n, 1)) * 99 + 1).astype(np.float32)

    def sampling_conditions(self, e_inc):
        return self.forward_conditions({"energy": np.asarray(e_inc, np.float32)})["energy"]

    def full_condition(self, u_samples, transformed_cond):
        return np.concatenate([transformed_cond, u_samples], axis=1)

    # ------------------------------------------------------------------ plot/eval
    def to_showers(self, samples, conditions):
        """Shape samples in the training basis -> the dict of GeV layers,
        u's and incident energies, every transform reversed."""
        bin_edges = [int(e) for e in self.cfg.data.bin_edges]
        samples = samples.reshape(samples.shape[0], -1)
        data = {"energy": conditions[:, :1], "extra_dims": conditions[:, 1:]}
        for i, key in enumerate(LAYER_KEYS):
            data[key] = samples[:, bin_edges[i]:bin_edges[i + 1]]
        for fn in self.transforms[::-1]:
            data = fn(data, rev=True)
        return data

    def energy_us(self, samples, conditions):
        """Energy-model samples and the test set's u's reversed down to (not
        including) ``NormalizeLayerEnergyGAN``, the ratios clipped to [0, 1]."""
        reference = self.test_dataset()
        samples_dict = {"extra_dims": samples, "energy": conditions}
        reference_dict = {"extra_dims": np.array(reference.layers),
                          "energy": np.array(reference.energy)}
        return tuple(clipped_ratios(reverse_until(self.transforms, d,
                                                  "NormalizeLayerEnergyGAN")["extra_dims"])
                     for d in (samples_dict, reference_dict))

    def plot(self):
        LOGGER.info("plot: generating samples")
        samples, conditions = self.sample_n()
        if self.cfg.model_type == "energy":
            from vit4hep_tpu_torch.evaluation.us_evaluation import eval_ui_dists, plot_ui_dists

            samples, reference = self.energy_us(samples, conditions)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                plot_ui_dists(samples, reference, cfg=self.cfg)
                eval_ui_dists(samples, reference, cfg=self.cfg, device=self.device)
        else:
            from vit4hep_tpu_torch.evaluation.calogan import eval_calogan_lowlevel

            data = self.to_showers(samples, conditions)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                eval_calogan_lowlevel(np.concatenate([data[k] for k in LAYER_KEYS], axis=1),
                                      self.cfg, device=self.device)

"""CaloChallenge experiment, training (port of the training part of
``vit4hep_tpu/experiments/calochallenge.py``).

Trains a CFM shape model (``model_type: shape``, conditioned on the
incident energy and the u-features) or energy model (``model_type:
energy``) on the CaloChallenge HDF5 datasets: the transform chain is fitted
and applied once on the host, and fixed-size batches go to the device. The
sampling half of the JAX experiment (``sample_n``, ``sample_us``,
``load_energy_model``, ``plot``, ``save_sample``, ``eval_sample``) is the
next slice of the port and raises here; the in-process two-stage generator
is ``utils/serving.Generator``. ``evaluate`` does nothing, as JAX's does:
the run's evaluation is its sampling and plotting.
"""

from __future__ import annotations

from vit4hep_tpu_torch.data.calochallenge.datasets import (BatchIterator, CaloChallengeDataset,
                                                            load_data)
from vit4hep_tpu_torch.data.calochallenge.transforms import build_pipeline
from vit4hep_tpu_torch.experiments.base import BaseExperiment
from vit4hep_tpu_torch.utils.logger import LOGGER

_NEXT_SLICE = ("is not ported yet: sampling and evaluation of the CaloChallenge experiment "
               "are the next slice (ROADMAP.md queue 1)")


class CaloChallenge(BaseExperiment):
    """Train a generative model on the CaloChallenge datasets."""

    def init_physics(self):
        pass

    def init_data(self):
        self.hdf5_train = self.cfg.data.training_file
        self.hdf5_test = self.cfg.data.test_file
        self.particle_type = self.cfg.data.particle_type
        self.xml_filename = self.cfg.data.xml_filename
        self.train_val_frac = list(self.cfg.data.train_val_frac)
        LOGGER.info("init_data: preparing model training")
        self.transforms = build_pipeline(self.cfg.data.transforms, self.cfg.run_dir)
        LOGGER.info("init_data: list of preprocessing steps:")
        for transform in self.transforms:
            LOGGER.info(f"{transform.__class__.__name__}")
        common = dict(particle_type=self.particle_type, xml_filename=self.xml_filename,
                      train_val_frac=self.train_val_frac, transform=self.transforms,
                      rank=self.rank, arrays=self.load_showers())
        self.train_dataset = CaloChallengeDataset(self.hdf5_train, split="training", **common)
        self.val_dataset = CaloChallengeDataset(self.hdf5_train, split="validation", **common)
        self.layer_boundaries = self.train_dataset.layer_boundaries

    def load_showers(self):
        """(incident energies (N, 1), layer-sorted showers in MeV (N, V),
        layer boundaries) of the training file."""
        return load_data(self.hdf5_train, self.particle_type, self.xml_filename)

    def _init_dataloader(self):
        self.batch_size = int(self.cfg.training.batchsize)
        seed = self.cfg.get("seed") or 0
        self.train_iterator = BatchIterator(
            (self.train_dataset.layers, self.train_dataset.energy), self.batch_size, seed=seed)
        self.batches_per_epoch = self.train_iterator.batches_per_epoch
        self._val_iterator = BatchIterator(
            (self.val_dataset.layers, self.val_dataset.energy),
            min(self.batch_size, len(self.val_dataset)), seed=seed, shuffle=False)
        LOGGER.info(f"init_dataloader: created training iterator with "
                    f"{self.batches_per_epoch} batches")
        LOGGER.info(f"init_dataloader: created validation iterator with "
                    f"{self._val_iterator.batches_per_epoch} batches")

    def val_batches(self):
        return self._val_iterator.epoch_batches()

    def _init_loss(self):
        if self.cfg.model_type not in ("shape", "energy"):
            raise ValueError(f"model_type {self.cfg.model_type} not implemented")

    def sample_n(self):
        raise NotImplementedError(f"CaloChallenge.sample_n {_NEXT_SLICE}")

    def sample_us(self, transformed_cond, batchsize_sample):
        raise NotImplementedError(f"CaloChallenge.sample_us {_NEXT_SLICE}")

    def load_energy_model(self):
        raise NotImplementedError(f"CaloChallenge.load_energy_model {_NEXT_SLICE}")

    def evaluate(self):
        pass

    def plot(self):
        raise NotImplementedError(f"CaloChallenge.plot {_NEXT_SLICE}")

    def save_sample(self, sample, energies, name=""):
        raise NotImplementedError(f"CaloChallenge.save_sample {_NEXT_SLICE}")

    def eval_sample(self, dirname=""):
        raise NotImplementedError(f"CaloChallenge.eval_sample {_NEXT_SLICE}")

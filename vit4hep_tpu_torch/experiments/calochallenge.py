"""CaloChallenge experiment (port of ``vit4hep_tpu/experiments/calochallenge.py``).

Trains a CFM shape model (``model_type: shape``, conditioned on the
incident energy and the u-features) or energy model (``model_type:
energy``) on the CaloChallenge HDF5 datasets: the transform chain is fitted
and applied once on the host, and fixed-size batches go to the device.
Samples through the experiment: ``sample_n`` draws incident energies,
transforms them, samples the u's from the separately trained energy model
(``sample_us``, staged through the host, or the two-stage chain of
``experiments/fused_chain`` with ``fused_generation``) and the showers in
fixed batches of ``training.batchsize_sample`` on the device. ``plot``
samples and evaluates (``evaluation/``); ``evaluate`` does nothing, as
JAX's does. h5py is imported only where HDF5 files are read or written.
"""

from __future__ import annotations

import os
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from vit4hep_tpu_torch.data.calochallenge.datasets import (BatchIterator, CaloChallengeDataset,
                                                            load_data)
from vit4hep_tpu_torch.data.calochallenge.transforms import build_pipeline
from vit4hep_tpu_torch.experiments.base import BaseExperiment
from vit4hep_tpu_torch.experiments.fused_chain import (UnsupportedTransform, chain_fingerprint,
                                                       make_fused_generate)
from vit4hep_tpu_torch.utils.checkpoint import load_checkpoint
from vit4hep_tpu_torch.utils.config import OmegaConf, instantiate
from vit4hep_tpu_torch.utils.logger import LOGGER


def _pad_batch(c, batch_size):
    """``c`` padded to ``batch_size`` rows by repeating its last row."""
    if len(c) < batch_size:
        c = np.concatenate([c, np.tile(c[-1:], (batch_size - len(c), 1))], axis=0)
    return np.asarray(c, np.float32)


class CaloChallenge(BaseExperiment):
    """Train a generative model on the CaloChallenge datasets."""

    # the condition layout of the two-stage chain (experiments/fused_chain)
    u_position = "first"
    energy_cond_width = None

    def init_physics(self):
        pass

    def build_transforms(self, transforms_cfg, run_dir):
        """The transform steps of a ``data.transforms`` mapping."""
        return build_pipeline(transforms_cfg, run_dir)

    def _log_transforms(self):
        LOGGER.info("init_data: list of preprocessing steps:")
        for transform in self.transforms:
            LOGGER.info(f"{transform.__class__.__name__}")

    def init_data(self):
        self.hdf5_train = self.cfg.data.training_file
        self.hdf5_test = self.cfg.data.test_file
        self.particle_type = self.cfg.data.particle_type
        self.xml_filename = self.cfg.data.xml_filename
        self.train_val_frac = list(self.cfg.data.train_val_frac)
        LOGGER.info("init_data: preparing model training")
        self.transforms = self.build_transforms(self.cfg.data.transforms, self.cfg.run_dir)
        self._log_transforms()
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

    def load_test_showers(self):
        """(incident energies, layer-sorted showers in MeV, layer boundaries)
        of the test file."""
        return load_data(self.hdf5_test, self.particle_type, self.xml_filename)

    def test_dataset(self):
        """The whole test file through this run's transform chain."""
        return CaloChallengeDataset(self.hdf5_test, self.particle_type, self.xml_filename,
                                    transform=self.transforms, split="full",
                                    arrays=self.load_test_showers())

    def evaluate(self):
        pass

    # ------------------------------------------------------------------ sampling
    def generate_Einc_ds1(self, sample_multiplier=1000):
        """ds1 incident-energy spectrum: log2-spaced 2^8..2^18 MeV plus
        thinned points at 2^19..2^22, shuffled by numpy's global generator."""
        ret = np.tile(np.logspace(8, 18, 11, base=2), 10)
        ret = np.array([*ret, *np.tile(2.0**19, 5), *np.tile(2.0**20, 3), *np.tile(2.0**21, 2),
                        *np.tile(2.0**22, 1)])
        ret = np.tile(ret, sample_multiplier)
        np.random.shuffle(ret)
        return ret

    def _batch_generator(self, stream, i):
        """The draws of batch ``i`` of the ``stream``-th sampling call: a
        generator on the device seeded from the experiment's seed, the
        stream and ``i``."""
        seed = np.random.SeedSequence([self.seed, stream, i]).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed) >> 1)

    def _next_stream(self):
        self._streams = getattr(self, "_streams", -1) + 1
        return self._streams

    def _batched(self, fn, conds, batch_size, noise):
        """``fn(cond, generator, noise) -> tuple of tensors`` over the
        conditions in fixed batches of ``batch_size``, the last one padded by
        repeating its last condition; every batch is launched before any
        result is copied to the host, and the padding is cut. ``noise[i]``,
        when given, is batch ``i``'s noise (padded batch size); else ``fn``
        draws from :meth:`_batch_generator`. Returns the outputs
        concatenated, as numpy arrays."""
        conds = np.asarray(conds, np.float32)
        stream = self._next_stream()
        pending = []
        with torch.no_grad():
            for i, start in enumerate(range(0, len(conds), batch_size)):
                c = conds[start:start + batch_size]
                c_dev = torch.as_tensor(_pad_batch(c, batch_size), device=self.device)
                x = None if noise is None else noise[i]
                pending.append((fn(c_dev, self._batch_generator(stream, i), x), len(c)))
        return tuple(np.concatenate([out[j][:k].cpu().numpy() for out, k in pending], axis=0)
                     for j in range(len(pending[0][0])))

    def _sample_in_batches(self, model, conds, batch_size, noise=None):
        """``model.sample_batch`` in fixed batches (:meth:`_batched`);
        ``noise[i]`` is batch ``i``'s initial noise, ``x_T`` or ``z``."""
        def fn(c, generator, x):
            x = None if x is None else torch.as_tensor(x, device=self.device)
            return (model.sample_batch(c, generator, x),)

        return self._batched(fn, conds, batch_size, noise)[0]

    def sample_n(self, noise=None):
        """``cfg.n_samples`` showers (u-vectors for an energy model) and their
        transformed conditions, in the training basis. E_inc is
        ``10 ** U(3, 6)`` from numpy's global generator for ds2/ds3, the ds1
        spectrum otherwise. ``noise``, when given, is ``(energy, shape)``:
        the per-batch noise lists of the energy model and of the shape model
        (an energy run samples only the first, a shape run without sample_us
        only the second). ``last_sampling_fused`` says afterwards whether
        the fused chain made the showers."""
        t_0 = time.time()
        if str(self.cfg.evaluation.eval_dataset) in ("2", "3"):
            e_inc = 10 ** np.random.uniform(3, 6, size=int(self.cfg.n_samples))
        else:
            e_inc = self.generate_Einc_ds1()
        transformed_cond = e_inc.astype(np.float32)[:, None]
        dummy = None
        for fn in self.transforms:
            if hasattr(fn, "cond_transform"):
                dummy, transformed_cond = fn(dummy, transformed_cond)
        return self._sample_conditions(transformed_cond, noise, t_0)

    def full_condition(self, u_samples, transformed_cond):
        """The shape model's condition from the sampled u's (in this run's
        basis) and the transformed condition."""
        return np.concatenate([u_samples, transformed_cond], axis=1)

    def truth_conditions(self):
        """The shape model's conditions with the test set's own u's."""
        return self.test_dataset().energy

    def _sample_conditions(self, transformed_cond, noise, t_0):
        """``sample_n``'s sampling for the transformed conditions: an energy
        model's u's, or showers on the sampled u's (staged ``sample_us``, or
        the fused chain with ``fused_generation``) or on the test set's."""
        batchsize_sample = int(self.cfg.training.batchsize_sample)
        energy_noise, shape_noise = (None, None) if noise is None else noise
        model_noise = energy_noise if self.cfg.model_type == "energy" else shape_noise
        if self.cfg.model_type == "shape":
            if self.cfg.sample_us:
                if self.cfg.get("fused_generation", False):
                    try:
                        return self._sample_n_fused(transformed_cond, batchsize_sample, t_0,
                                                    noise)
                    except UnsupportedTransform as e:
                        (LOGGER.debug if getattr(e, "cached", False) else LOGGER.warning)(
                            f"fused_generation: {e}; using the staged path")
                u_samples = self.sample_us(transformed_cond, batchsize_sample, energy_noise)
                transformed_cond = self.full_condition(u_samples, transformed_cond)
            else:
                transformed_cond = self.truth_conditions()

        sample = self._sample_in_batches(self.model, transformed_cond, batchsize_sample,
                                         model_noise)
        self.last_sampling_time, self.last_sampling_fused = time.time() - t_0, False
        LOGGER.info(f"sample_n: Finished generating {len(sample)} samples after "
                    f"{self.last_sampling_time} s.")
        return sample, np.asarray(transformed_cond)

    def _fused_generator(self):
        """The two-stage generator of this model and the energy model, built
        once per (energy model path, chain fingerprint); a chain with a
        transform without a device twin is remembered, and raises."""
        self._energy_model_for_cfg()
        key = (str(self.cfg.energy_model),
               chain_fingerprint(self.energy_model_transforms, self.transforms))
        if getattr(self, "_fused_gen_key", None) != key:
            self._fused_gen_key = key
            try:
                self._fused_gen = make_fused_generate(
                    self.model, self.energy_model, self.energy_model_transforms,
                    self.transforms, self.u_position, self.energy_cond_width)
            except UnsupportedTransform:
                self._fused_gen = None
                raise
        if self._fused_gen is None:
            e = UnsupportedTransform("fused chain unavailable for this transform pipeline "
                                     "(cached verdict)")
            e.cached = True
            raise e
        return self._fused_gen

    def _sample_n_fused(self, transformed_cond, batch_size, t_0, noise=None):
        """Two-stage generation in one device pass per batch: energy ODE, the
        u mapping on the device, shape model, in the batches of
        :meth:`_batched`. ``noise`` is ``(energy, shape)`` per-batch lists
        when given."""
        gen = self._fused_generator()

        def fn(c, generator, x):
            x = None if x is None else tuple(torch.as_tensor(a, device=self.device) for a in x)
            return gen(c, generator, x)

        sample, full_cond = self._batched(fn, transformed_cond, batch_size,
                                          None if noise is None else list(zip(*noise)))
        self.last_sampling_time, self.last_sampling_fused = time.time() - t_0, True
        LOGGER.info(f"sample_n (fused chain): Finished generating {len(sample)} samples after "
                    f"{self.last_sampling_time} s.")
        return sample, full_cond

    def sample_us(self, transformed_cond, batchsize_sample, noise=None):
        """u-vectors from the separately trained energy model, mapped into this
        model's u basis: the energy run's ``u_transform`` steps reversed, then
        this run's forward. ``noise`` as in :meth:`_sample_in_batches`."""
        self._energy_model_for_cfg()
        t_0 = time.time()
        u_samples = self._sample_in_batches(self.energy_model, transformed_cond,
                                            batchsize_sample, noise)
        LOGGER.info(f"sample_us: Finished generating {len(u_samples)} energy samples after "
                    f"{time.time() - t_0} s.")
        for fn in self.energy_model_transforms[::-1]:
            if hasattr(fn, "u_transform"):
                u_samples, _ = fn(u_samples, None, rev=True)
        for fn in self.transforms:
            if hasattr(fn, "u_transform"):
                u_samples, _ = fn(u_samples, None)
        return np.asarray(u_samples, np.float32)

    def energy_run_config(self):
        """The energy run's composed config, read from its ``config.yaml``."""
        return OmegaConf.load(os.path.join(str(self.cfg.energy_model), "config.yaml"))

    def load_energy_model(self):
        """Instantiate the energy model of ``cfg.energy_model`` on the device
        with its run's ``models/model_run0.pt`` weights, and build its
        transform chain."""
        path = str(self.cfg.energy_model)
        energy_cfg = self.energy_run_config()
        self.energy_model_transforms = self.build_transforms(energy_cfg.data.transforms,
                                                             str(energy_cfg.run_dir))
        model_path = os.path.join(str(energy_cfg.run_dir), "models", "model_run0.pt")
        model = instantiate(energy_cfg.model)
        model.load_state_dict(load_checkpoint(model_path)["model"])
        self.energy_model = model.to(self.device).eval()
        self._energy_model_path = path
        LOGGER.info(f"Loaded energy model from {model_path}")

    def _energy_model_for_cfg(self):
        """Load the energy model unless the one of ``cfg.energy_model`` is
        loaded already."""
        if getattr(self, "_energy_model_path", None) != str(self.cfg.energy_model):
            self.load_energy_model()

    # ------------------------------------------------------------------ plot/eval
    def to_mev(self, samples, conditions):
        """Shape samples in the training basis -> (MeV voxels, incident
        energies): the channel dropped, every transform reversed."""
        samples = samples[:, 0]
        for fn in self.transforms[::-1]:
            samples, conditions = fn(samples, conditions, rev=True)
        return samples, conditions

    def energy_us(self, samples, conditions):
        """Energy-model samples and the test set's u's reversed down to (not
        including) ``NormalizeByElayer``, the ratios clipped to [0, 1]."""
        reference = self.test_dataset().layers
        for fn in self.transforms[::-1]:
            if fn.__class__.__name__ == "NormalizeByElayer":
                break
            samples, _ = fn(samples, conditions, rev=True)
            reference, _ = fn(reference, conditions, rev=True)
        samples[:, 1:] = np.clip(samples[:, 1:], 0.0, 1.0)
        reference[:, 1:] = np.clip(reference[:, 1:], 0.0, 1.0)
        return np.asarray(samples), np.asarray(reference)

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
            from vit4hep_tpu_torch.evaluation.ugr_evaluation import run_from_py

            samples, conditions = self.to_mev(samples, conditions)
            self.save_sample(samples, conditions, name=f"_{self.cfg.run_idx}")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                run_from_py(samples, conditions, self.cfg, device=self.device)

    def eval_sample(self, dirname=""):
        from vit4hep_tpu_torch.evaluation.ugr_evaluation import run_from_py

        samples, energies = self.load_sample(dirname=dirname)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            run_from_py(samples, energies, self.cfg, device=self.device)

    def save_sample(self, sample, energies, name=""):
        import h5py  # host-side writer; the card's machine has none

        save_path = Path(self.cfg.run_dir) / f"samples{name}.hdf5"
        with h5py.File(save_path, "w") as f:
            f.create_dataset("incident_energies", data=energies, compression="gzip")
            f.create_dataset("showers", data=sample, compression="gzip")

    def load_sample(self, dirname=""):
        import h5py  # host-side reader; the card's machine has none

        if dirname == "":
            dirname = str(Path(self.cfg.run_dir) / f"samples_{self.cfg.run_idx}.hdf5")
        LOGGER.info(f"load_sample: loading samples from {dirname}")
        with h5py.File(dirname, "r") as f:
            energies = f["incident_energies"][:]
            sample = f["showers"][:]
        return sample, energies

"""What the CaloGAN, LEMURS and CaloHadronic experiments share: the
CaloChallenge lifecycle (training, batched sampling, the two-stage chain)
over dict-protocol transform pipelines (``data/pipeline.py``).

The conditions ``sample_n`` draws (incident energies, LEMURS's angles) come
from an explicit numpy generator seeded from the experiment's seed, or are
handed in by the caller (``conditions=``), where the JAX experiments draw
from numpy's global generator.
"""

from __future__ import annotations

import time
import warnings
from pathlib import Path

import numpy as np

from vit4hep_tpu_torch.data.lemurs.datasets import (ArrayEvents, CollatedBatchIterator,
                                                     enable_native_cache, read_first_file)
from vit4hep_tpu_torch.data.pipeline import reverse_until
from vit4hep_tpu_torch.experiments.calochallenge import CaloChallenge
from vit4hep_tpu_torch.utils.logger import LOGGER


class DictFamilyExperiment(CaloChallenge):
    """A family whose transforms map dicts of arrays; subclasses set
    ``pipeline`` (the family's ``build_pipeline``) and implement
    ``init_data``, ``draw_conditions``, ``sampling_conditions`` and
    ``plot``."""

    pipeline = None

    def build_transforms(self, transforms_cfg, run_dir):
        return type(self).pipeline(transforms_cfg, run_dir)

    def forward_conditions(self, data_dict):
        """``data_dict`` through this run's ``cond_transform`` steps."""
        for fn in self.transforms:
            if hasattr(fn, "cond_transform"):
                data_dict = fn(data_dict)
        return data_dict

    def conditions_rng(self) -> np.random.Generator:
        """A numpy generator for the next call's condition draws, seeded
        from the experiment's seed and the call's index."""
        self._cond_draws = getattr(self, "_cond_draws", -1) + 1
        return np.random.default_rng([self.seed, self._cond_draws])

    def sample_n(self, noise=None, conditions=None):
        """``cfg.n_samples`` showers (u-vectors for an energy model) and
        their transformed conditions, in the training basis, as
        CaloChallenge's ``sample_n``. ``conditions`` are the drawn physical
        conditions (:meth:`draw_conditions`'s result), drawn here when
        None."""
        t_0 = time.time()
        if conditions is None:
            conditions = self.draw_conditions(int(self.cfg.n_samples), self.conditions_rng())
        return self._sample_conditions(self.sampling_conditions(conditions), noise, t_0)

    def sample_us(self, transformed_cond, batchsize_sample, noise=None):
        """u-vectors from the separately trained energy model (on the first
        ``energy_cond_width`` condition columns), mapped into this run's u
        basis: the energy run's ``u_transform`` steps reversed, then this
        run's forward, on a u-only dict. The shared pipelines' keys are never
        narrowed: the steps skip the keys a dict lacks."""
        self._energy_model_for_cfg()
        t_0 = time.time()
        e_cond = np.asarray(transformed_cond, np.float32)
        if self.energy_cond_width is not None:
            e_cond = e_cond[:, :self.energy_cond_width]
        u_samples = self._sample_in_batches(self.energy_model, e_cond, batchsize_sample, noise)
        LOGGER.info(f"sample_us: Finished generating {len(u_samples)} energy samples after "
                    f"{time.time() - t_0} s.")
        u_dict = {"extra_dims": u_samples}
        for fn in self.energy_model_transforms[::-1]:
            if hasattr(fn, "u_transform"):
                u_dict = fn(u_dict, rev=True)
        for fn in self.transforms:
            if hasattr(fn, "u_transform"):
                u_dict = fn(u_dict)
        return np.asarray(u_dict["extra_dims"], np.float32)

    def save_sample(self, samples_dict, name=""):
        """Every array of ``samples_dict`` into ``<run_dir>/samples<name>.hdf5``."""
        import h5py  # host-side writer; the card's machine has none

        with h5py.File(Path(self.cfg.run_dir) / f"samples{name}.hdf5", "w") as f:
            for key, value in samples_dict.items():
                f.create_dataset(key, data=np.asarray(value), compression="gzip")


class LazyFamilyExperiment(DictFamilyExperiment):
    """LEMURS and CaloHadronic: lazy datasets over {label: [files]} whose
    batches a collator transforms on the host; subclasses implement
    ``open_events``, ``collator(files, return_us, **kw)``, ``u_dict``,
    ``energy_eval_inputs`` and ``to_showers``, and name ``ratio_step`` (the
    step whose u's the energy evaluation reads), ``evaluation`` (the module
    of ``run_from_py``) and ``sample_keys`` (its arrays). With
    ``data.native_cache`` set, both splits read their events from record
    caches in that directory (:meth:`open_datasets`)."""

    ratio_step = None
    evaluation = None
    sample_keys = ()

    def warmup_events(self, files_dict):
        """Every event of the first file of ``files_dict``, as the family's
        ``load_data`` reads it: a pipeline's file-backed state is fitted on
        them where its statistics are missing."""
        return read_first_file(files_dict, self.load_data)

    def open_datasets(self):
        """Both splits' datasets (``open_events``), each reading from a
        record cache under ``data.native_cache`` when it is set."""
        self.train_dataset = self.open_events(self.hdf5_dict_train)
        self.val_dataset = self.open_events(self.hdf5_dict_test)
        cache_dir = self.cfg.data.get("native_cache")
        if cache_dir:
            spec = self.event_spec()
            enable_native_cache(self.train_dataset, cache_dir, spec)
            enable_native_cache(self.val_dataset, cache_dir, spec)

    def event_spec(self) -> dict:
        """``{field: per-event shape}`` of the training events: of the events
        in memory, or of the first event of the first training file."""
        if isinstance(self.train_dataset, ArrayEvents):
            return self.train_dataset.spec()
        import h5py  # host-side reader; the card's machine has none

        with h5py.File(next(iter(self.hdf5_dict_train.values()))[0], "r") as f:
            sample = self.load_data(f, local_index=0)
        return {k: tuple(v.shape[1:]) for k, v in sample.items()}

    def load_energy_model(self):
        super().load_energy_model()
        warmup = self.warmup_events(self.hdf5_dict_train)
        for fn in self.energy_model_transforms:
            warmup = fn(warmup, rank=self.rank)

    def _init_dataloader(self):
        collator = self.collator(self.hdf5_dict_train, self.return_us)
        self.batch_size = self.global_batch(int(self.cfg.training.batchsize))
        seed = self.cfg.get("seed") or 0
        self.train_iterator = CollatedBatchIterator(self.train_dataset, collator,
                                                    self.batch_size, seed=seed)
        self.batches_per_epoch = self.train_iterator.batches_per_epoch
        self._val_iterator = CollatedBatchIterator(self.val_dataset, collator, self.batch_size,
                                                   seed=seed, shuffle=False)
        LOGGER.info(f"init_dataloader: created training iterator with "
                    f"{self.batches_per_epoch} batches")

    def _test_batches(self, return_us, **kw):
        """The test split collated in batches of ``batchsize_sample``, the last
        one short; the collator's state is fitted on the first test file."""
        it = CollatedBatchIterator(self.val_dataset,
                                   self.collator(self.hdf5_dict_test, return_us, **kw),
                                   int(self.cfg.training.batchsize_sample), shuffle=False,
                                   drop_last=False)
        return list(it.epoch_batches())

    def energy_us(self, samples, conditions):
        """(samples' dict, reference u's, reference conditions): energy-model
        samples and the test set's u's reversed through the ``u_transform``
        steps down to (not including) ``ratio_step``, the ratios clipped to
        [0, 1]."""
        pairs = self._test_batches(True)
        reference_us = np.concatenate([u for u, _ in pairs], axis=0)
        reference_conds = np.concatenate([c for _, c in pairs], axis=0)
        samples_dict = reverse_until(self.transforms, self.u_dict(samples, conditions),
                                     self.ratio_step, u_only=True)
        reference_dict = reverse_until(self.transforms,
                                       self.u_dict(reference_us, reference_conds),
                                       self.ratio_step, u_only=True)
        for d in (samples_dict, reference_dict):
            d["extra_dims"] = clipped_ratios(d["extra_dims"])
        return samples_dict, reference_dict["extra_dims"], reference_conds

    def run_evaluation(self, *arrays):
        import importlib

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            importlib.import_module(self.evaluation).run_from_py(*arrays, self.cfg,
                                                                  device=self.device)

    def plot(self):
        LOGGER.info("plot: generating samples")
        samples, conditions = self.sample_n()
        if self.cfg.model_type == "energy":
            from vit4hep_tpu_torch.evaluation.us_evaluation import eval_ui_dists, plot_ui_dists

            samples_dict, reference_u, reference_conds = self.energy_us(samples, conditions)
            self.save_sample(samples_dict, name=f"_{self.cfg.run_idx}")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                plot_ui_dists(samples_dict["extra_dims"], reference_u, cfg=self.cfg)
                eval_ui_dists(*self.energy_eval_inputs(samples_dict["extra_dims"], conditions,
                                                       reference_u, reference_conds),
                              cfg=self.cfg, device=self.device)
        else:
            data = self.to_showers(samples, conditions)
            self.save_sample(data, name=f"_{self.cfg.run_idx}")
            self.run_evaluation(*(np.asarray(data[k]) for k in self.sample_keys))

    def eval_sample(self, dirname=""):
        self.run_evaluation(*self.load_sample(dirname=dirname))

    def load_sample(self, dirname=""):
        """The ``sample_keys`` arrays of a saved sample file (as
        ``save_sample`` writes them, or in an ``events`` table)."""
        import h5py  # host-side reader; the card's machine has none

        if dirname == "":
            dirname = str(Path(self.cfg.run_dir) / f"samples_{self.cfg.run_idx}.hdf5")
        LOGGER.info(f"load_sample: loading samples from {dirname}")
        with h5py.File(dirname, "r") as f:
            src = f["events"][:] if "events" in f else f
            return tuple(np.asarray(src[k]) for k in self.sample_keys)


def clipped_ratios(us):
    """A copy of the u's with the ratios u_1.. clipped to [0, 1]."""
    us = np.array(us)
    us[:, 1:] = np.clip(us[:, 1:], 0.0, 1.0)
    return us

"""LEMURS multi-detector experiment (port of
``vit4hep_tpu/experiments/lemurs.py``).

Trains a CFM energy or shape model over the detector classes with the lazy
multi-file pipeline (``data/lemurs/datasets.py``), samples over (E, theta,
phi, one-hot label) conditions, and evaluates with the angle-sliced
harness (``evaluation/lemurs.py``). The shape model's condition is ``[u |
E, theta, phi | labels]``; the energy model sees ``[E, theta, phi]``
(``energy_cond_width = 3``). The readers are methods
(:meth:`LEMURS.open_events`, :meth:`LEMURS.warmup_events`), so that a
subclass can hand in events.
"""

from __future__ import annotations

import numpy as np

from vit4hep_tpu_torch.data.lemurs.datasets import (COND_KEYS, LEMURSCollator, LEMURSDataset,
                                                     load_data)
from vit4hep_tpu_torch.data.lemurs.transforms import build_pipeline
from vit4hep_tpu_torch.experiments.families import LazyFamilyExperiment


class LEMURS(LazyFamilyExperiment):
    pipeline = staticmethod(build_pipeline)
    load_data = staticmethod(load_data)
    energy_cond_width = len(COND_KEYS)
    ratio_step = "LEMURSNormalizeByElayer"
    evaluation = "vit4hep_tpu_torch.evaluation.lemurs"
    sample_keys = ("showers", *COND_KEYS)

    def init_data(self):
        self.hdf5_dict_train = {k: list(v) for k, v in self.cfg.data.training_file_dict.items()}
        self.hdf5_dict_test = {k: list(v) for k, v in self.cfg.data.test_file_dict.items()}
        self.num_classes = int(self.cfg.data.num_classes)
        self.max_files_per_worker = int(self.cfg.data.max_files_per_worker)
        self.return_us = bool(self.cfg.data.return_us)
        self.transforms = self.build_transforms(self.cfg.data.transforms, self.cfg.run_dir)
        self._log_transforms()
        self.open_datasets()

    def open_events(self, files_dict):
        """The lazy dataset over one split's files."""
        return LEMURSDataset(files_dict, max_files_per_worker=self.max_files_per_worker)

    def collator(self, files_dict, return_us, gen_label=None):
        return LEMURSCollator(hdf5_train_dict=files_dict, transforms=self.transforms,
                              num_classes=self.num_classes, gen_label=gen_label,
                              return_us=return_us, rank=self.rank,
                              warmup=self.warmup_events(files_dict))

    # ------------------------------------------------------------------ sampling
    def draw_conditions(self, n, rng):
        """(E_inc, phi, theta), each (n, 1), from the configured generation
        windows: E and phi uniform (phi fixed when ``gen_phi`` is set),
        theta uniform in cos(theta)."""
        # YAML reads 1e3 as a string
        gen_e = [float(v) for v in self.cfg.data.gen_Einc]
        gen_theta = [float(v) for v in self.cfg.data.gen_theta]
        gen_phi = self.cfg.data.gen_phi
        # lo + (hi - lo) U, as numpy's legacy uniform: cos(theta) falls
        # from its first bound to its second
        uniform = lambda lo, hi: lo + (hi - lo) * rng.random(n)  # noqa: E731
        e_inc = uniform(*gen_e) if len(gen_e) == 2 else np.full(n, gen_e[0])
        phi = uniform(-np.pi, np.pi) if gen_phi is None else np.full(n, float(gen_phi[0]))
        cos_theta = uniform(np.cos(gen_theta[0]), np.cos(gen_theta[1])) \
            if len(gen_theta) == 2 else np.full(n, np.cos(gen_theta[0]))
        return (e_inc[:, None].astype(np.float32), phi[:, None].astype(np.float32),
                np.arccos(cos_theta)[:, None].astype(np.float32))

    def label_vectors(self, n):
        """``data.gen_label_vector`` for each of n showers."""
        return np.tile(np.asarray(list(self.cfg.data.gen_label_vector), np.float32), (n, 1))

    def sampling_conditions(self, conditions):
        """[E, theta, phi] transformed, and for a shape model the labels
        after them."""
        e_inc, phi, theta = conditions
        d = self.forward_conditions({"incident_energy": e_inc, "incident_phi": phi,
                                     "incident_theta": theta})
        cond = np.concatenate([d[k] for k in COND_KEYS], axis=-1)
        if self.cfg.model_type == "shape":
            cond = np.concatenate([cond, self.label_vectors(len(cond))], axis=1)
        return cond

    def truth_conditions(self):
        gen_label = list(self.cfg.data.gen_label_vector)
        return np.concatenate([c for _, c in self._test_batches(False, gen_label=gen_label)],
                              axis=0)

    # ------------------------------------------------------------------ plot/eval
    def to_showers(self, samples, conditions):
        """Shape samples (B, 1, L, W, H) in the training basis -> the dict of
        MeV showers (B, H, W, L), u's, E, theta, phi and labels, every
        transform reversed."""
        samples = np.transpose(samples[:, 0], (0, 3, 2, 1))
        n_us = samples.shape[-1]
        data = {"showers": samples, "extra_dims": conditions[:, :n_us]}
        for i, key in enumerate(COND_KEYS):
            data[key] = conditions[:, n_us + i:n_us + i + 1]
        data["label"] = conditions[:, n_us + 3:]
        for fn in self.transforms[::-1]:
            data = fn(data, rev=True)
        return data

    def u_dict(self, us, conds):
        return {"extra_dims": us, **{k: conds[:, i:i + 1] for i, k in enumerate(COND_KEYS)},
                "label": conds[:, 3:]}

    def energy_eval_inputs(self, samples_u, conditions, reference_u, reference_conds):
        """The u's and [E, theta, phi] side by side."""
        return (np.concatenate([samples_u, conditions[:, :3]], axis=1),
                np.concatenate([reference_u, reference_conds[:, :3]], axis=1))

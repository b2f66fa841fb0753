"""In-process two-stage shower generator (port of the serving path of
``vit4hep_tpu/utils/serving.py``).

:class:`Generator` does the work of ``export_generator`` + ``LoadedSampler``
without the artifact: ``generator(cond, seed)`` returns showers in the shape
model's training basis, ``generator.sample_showers(E_inc, seed)`` returns
MeV voxels through the host transform pipeline. The ``torch.export``
artifact is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from vit4hep_tpu_torch.data.calochallenge.transforms import apply_pipeline
from vit4hep_tpu_torch.experiments.fused_chain import make_fused_generate


class Generator:
    """Fixed-batch two-stage generator over an energy model and a shape
    model, with their transform pipelines (lists of the steps of
    ``vit4hep_tpu_torch.data.calochallenge.transforms``)."""

    def __init__(self, shape_model, energy_model, energy_transforms, shape_transforms,
                 batch: int):
        self.shape_model = shape_model
        self.energy_model = energy_model
        self.shape_transforms = list(shape_transforms)
        self.batch = int(batch)
        self._generate = make_fused_generate(shape_model, energy_model, energy_transforms,
                                             shape_transforms)
        self.cond_dim = int(shape_model.condition_dim) - int(energy_model.shape[0])

    @property
    def device(self) -> torch.device:
        return self.shape_model.device

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def generate(self, cond, seed: int = 0, noise=None):
        """(shower, full_cond) for a (batch, cond_dim) transformed condition."""
        cond = torch.as_tensor(cond, dtype=torch.float32, device=self.device)
        if tuple(cond.shape) != (self.batch, self.cond_dim):
            raise ValueError(f"generator was built for cond shape ({self.batch}, "
                             f"{self.cond_dim}), got {tuple(cond.shape)}")
        return self._generate(cond, generator=self._generator(seed), noise=noise)

    def __call__(self, cond, seed: int = 0, noise=None):
        """Showers in the shape model's training basis, (batch, C, L, A, R)."""
        return self.generate(cond, seed, noise)[0]

    def condition(self, e_inc_mev) -> np.ndarray:
        """The transformed condition for incident energies in MeV: the shape
        pipeline's ``cond_transform`` steps, forward."""
        cond = np.asarray(e_inc_mev, np.float32).reshape(-1, 1)
        for fn in self.shape_transforms:
            if hasattr(fn, "cond_transform"):
                _, cond = fn(None, cond)
        return cond

    def sample_showers(self, e_inc_mev, seed: int = 0, noise=None) -> np.ndarray:
        """MeV voxels (batch, n_voxels) for incident energies in MeV: the
        condition transformed, generation, the channel dropped, then every
        shape transform reversed, in reverse order."""
        shower, full_cond = self.generate(self.condition(e_inc_mev), seed, noise)
        samples, _ = apply_pipeline(self.shape_transforms, shower.cpu().numpy()[:, 0],
                                    full_cond.cpu().numpy(), rev=True)
        return samples

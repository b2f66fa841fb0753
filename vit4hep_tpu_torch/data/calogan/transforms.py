"""CaloGAN's dict-protocol preprocessing steps (port of
``vit4hep_tpu/data/calogan/transforms.py``; numpy, on the host).

Each step maps a dict with keys ``layer_0``/``layer_1``/``layer_2`` (the
three layers, flat), ``extra_dims`` (the u's) and ``energy`` and is reversed
by ``rev=True``. The marker attributes ``u_transform`` and
``cond_transform`` select the steps applied to sampled u's and to the
conditions at generation time.
"""

from __future__ import annotations

import numpy as np

from vit4hep_tpu_torch.data.pipeline import DictExclusiveLogit, DictGlobalStandardize, build_steps

LAYER_KEYS = ["layer_0", "layer_1", "layer_2"]


class GlobalStandardizeFromFileGAN(DictGlobalStandardize):
    """One mean/std over the non-saturated logits of every layer key and
    the u's, in the run dir's ``means.npy``/``stds.npy``; fitted on the
    first forward call when they are missing."""

    keys = LAYER_KEYS + ["extra_dims"]

    @staticmethod
    def values(data_dict, keys):
        """The events' layers and u's side by side, (B, voxels + u's)."""
        return np.concatenate([data_dict[k] for k in keys], axis=1)


class LogEnergyGAN:
    """log(E + alpha) of the incident energy."""

    def __init__(self, alpha=0.0):
        self.alpha = float(alpha)
        self.cond_transform = True

    def __call__(self, data_dict, rev=False, rank=0):
        e = data_dict["energy"]
        data_dict["energy"] = np.exp(e) - self.alpha if rev else np.log(e + self.alpha)
        return data_dict


class ScaleEnergyGAN:
    """Min-max scale of the (log-)energy to [0, 1]."""

    def __init__(self, e_min, e_max):
        self.e_min = float(e_min)
        self.e_max = float(e_max)
        self.cond_transform = True

    def __call__(self, data_dict, rev=False, rank=0):
        e = data_dict["energy"]
        if rev:
            data_dict["energy"] = e * (self.e_max - self.e_min) + self.e_min
        else:
            data_dict["energy"] = (e - self.e_min) / (self.e_max - self.e_min)
        return data_dict


class ExclusiveLogitTransformGAN(DictExclusiveLogit):
    """(Rescaled) logit of the layer voxels and the u's. ``exclusions`` is
    kept and never applied, as in the reference."""

    keys = LAYER_KEYS + ["extra_dims"]

    def __init__(self, delta, exclusions=None, rescale=False):
        super().__init__(delta, rescale)
        self.exclusions = exclusions


class NormalizeLayerEnergyGAN:
    """The u's of the three layers: each layer normalized to unit sum, and
    ``extra_dims`` = (u_0 = E_tot / E_inc, u_i = E_i / E_{>=i}); the reverse
    rebuilds the layer energies recursively (the u's clipped in place, as
    the reference saves them)."""

    def __init__(self, cut=0.0, eps=1.0e-10):
        self.bin_edges = [0, 288, 432, 504]
        self.eps = float(eps)
        self.cut = float(cut)
        self.layer_keys = LAYER_KEYS
        self.n_layers = 3

    def __call__(self, data_dict, rev=False, rank=0):
        energy = data_dict["energy"]
        if rev:
            us = np.array(data_dict["extra_dims"])
            us[:, -(self.n_layers - 1):] = np.clip(us[:, -(self.n_layers - 1):], 0.0, 1.0)
            data_dict["extra_dims"] = us
            total_e = energy.reshape(-1) * us[:, 0]
            layer_es = []
            cum = np.zeros_like(total_e)
            for i in range(us.shape[-1] - 1):
                e_i = (total_e - cum) * us[:, i + 1]
                layer_es.append(e_i)
                cum = cum + e_i
            layer_es.append(total_e - cum)
            layer_es = np.stack(layer_es, axis=1)
            for i, key in enumerate(self.layer_keys):
                layer = np.array(data_dict[key])
                layer = layer / (layer.sum(-1, keepdims=True) + self.eps)
                layer[layer <= self.cut] = 0.0
                data_dict[key] = layer * layer_es[:, [i]]
        else:
            layer_es = []
            for key in self.layer_keys:
                e_l = data_dict[key].sum(axis=1, keepdims=True)
                data_dict[key] = data_dict[key] / (e_l + self.eps)
                layer_es.append(e_l)
            layer_es = np.concatenate(layer_es, axis=1)
            extra = [layer_es.sum(axis=1, keepdims=True) / energy.reshape(-1, 1)]
            for i in range(layer_es.shape[1] - 1):
                remaining = layer_es[:, i:].sum(axis=1, keepdims=True)
                extra.append(layer_es[:, [i]] / (remaining + self.eps))
            data_dict["extra_dims"] = np.concatenate(extra, axis=1)
        return data_dict


STEPS = {cls.__name__: cls for cls in (
    GlobalStandardizeFromFileGAN, LogEnergyGAN, ScaleEnergyGAN, ExclusiveLogitTransformGAN,
    NormalizeLayerEnergyGAN)}


def build_pipeline(transforms_cfg, run_dir):
    """The ordered steps of ``cfg.data.transforms``; ``run_dir`` is every
    ``*FromFile`` step's ``model_dir``."""
    return build_steps(STEPS, transforms_cfg, str(run_dir))

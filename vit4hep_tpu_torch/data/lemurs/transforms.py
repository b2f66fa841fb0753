"""LEMURS's dict-protocol preprocessing steps (port of
``vit4hep_tpu/data/lemurs/transforms.py``; numpy, on the host).

Each step maps a dict with keys ``showers`` (B, H, W, L), ``extra_dims``
(the u's), ``incident_energy``/``incident_theta``/``incident_phi`` and
``label``, and is reversed by ``rev=True``. The u's of
``LEMURSNormalizeByElayer`` come from a right-to-left cumulative sum.
"""

from __future__ import annotations

import numpy as np

from vit4hep_tpu_torch.data.pipeline import (DictCutValues, DictExclusiveLogit,
                                             DictGlobalStandardize, DictScaleTotalEnergy,
                                             DictStandardizeUs, build_steps, layers_of_ratios,
                                             ratios_of_layers)


class LEMURSGlobalStandardizeFromFile(DictGlobalStandardize):
    """One mean/std over the non-saturated logits of the showers and the
    u's, in the run dir's ``means.npy``/``stds.npy``."""

    keys = ["showers", "extra_dims"]


class LEMURSStandardizeUsFromFile(DictStandardizeUs):
    """Per-component standardization of the u's, in the run dir's
    ``means_u.npy``/``stds_u.npy``."""


class LEMURSPreprocessConds:
    """Min-max scale of E, theta and phi to [0, 1]."""

    def __init__(self, scale_E=(1e3, 1e6), scale_theta=(0.87, 2.27),
                 scale_phi=(-3.1416, 3.1416)):
        self.cond_transform = True
        self.keys = ["incident_energy", "incident_theta", "incident_phi"]
        self.rescaling = [list(scale_E), list(scale_theta), list(scale_phi)]

    def __call__(self, data_dict, rev=False, rank=0):
        for n, key in enumerate(self.keys):
            lo, hi = self.rescaling[n]
            if rev:
                data_dict[key] = data_dict[key] * (hi - lo) + lo
            else:
                data_dict[key] = (data_dict[key] - lo) / (hi - lo)
        return data_dict


class LEMURSScaleTotalEnergy(DictScaleTotalEnergy):
    """u_0 = E_tot / E_inc scaled by a factor."""


class LEMURSExclusiveLogitTransform(DictExclusiveLogit):
    """(Rescaled) logit of the showers and the u's."""

    keys = ["showers", "extra_dims"]


class LEMURSCutValues(DictCutValues):
    """The reverse-only cut in the normalized space."""

    keys = ["showers"]


class LEMURSNormalizeByElayer:
    """The u's of (B, H, W, L) showers: each layer normalized to unit sum,
    u_0 = E_tot / E_inc and u_i = E_i / E_{>=i}; the reverse rebuilds the
    layer energies recursively (the u's clipped in place, as the reference
    saves them)."""

    def __init__(self, cut=0.0, eps=1.0e-10):
        self.eps = float(eps)
        self.cut = float(cut)

    def __call__(self, data_dict, rev=False, rank=0):
        shower = np.array(data_dict["showers"])
        b, h, w, n_layers = shower.shape
        if rev:
            layer_es = layers_of_ratios(data_dict, "incident_energy").reshape(b, 1, 1, n_layers)
            shower = shower / (shower.sum(axis=(1, 2), keepdims=True) + self.eps)
            if self.cut > 0.0:
                shower[shower <= self.cut] = 0.0
            shower = shower * layer_es
        else:
            layer_es = shower.sum(axis=(1, 2))  # (B, L)
            shower = shower / (layer_es.reshape(b, 1, 1, n_layers) + self.eps)
            data_dict["extra_dims"] = ratios_of_layers(layer_es, data_dict["incident_energy"],
                                                       self.eps)
        data_dict["showers"] = shower
        return data_dict


STEPS = {cls.__name__: cls for cls in (
    LEMURSGlobalStandardizeFromFile, LEMURSStandardizeUsFromFile, LEMURSPreprocessConds,
    LEMURSScaleTotalEnergy, LEMURSExclusiveLogitTransform, LEMURSCutValues,
    LEMURSNormalizeByElayer)}


def build_pipeline(transforms_cfg, run_dir):
    """The ordered steps of ``cfg.data.transforms``; ``run_dir`` is every
    ``*FromFile`` step's ``model_dir``."""
    return build_steps(STEPS, transforms_cfg, str(run_dir))

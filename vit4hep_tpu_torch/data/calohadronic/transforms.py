"""CaloHadronic's dict-protocol preprocessing steps (port of
``vit4hep_tpu/data/calohadronic/transforms.py``; numpy, on the host).

Each step maps a dict with keys ``ecal`` (B, 10|30, 15|180, 15|180),
``hcal`` (B, 48, 30, 30), ``extra_dims`` (the 58 u's over the ECal and HCal
layers together) and ``energy``. ``SumPool3dDownScale`` is the
irreversible 30x180x180 -> 10x15x15 ECal downsample.
"""

from __future__ import annotations

import numpy as np

from vit4hep_tpu_torch.data.pipeline import (DictCutValues, DictExclusiveLogit,
                                             DictGlobalStandardize, DictScaleTotalEnergy,
                                             DictStandardizeUs, build_steps, layers_of_ratios,
                                             ratios_of_layers)

CALO_KEYS = ["ecal", "hcal"]


class CaloHadGlobalStandardizeFromFile(DictGlobalStandardize):
    """One mean/std over the non-saturated logits of ECal, HCal and the
    u's, in the run dir's ``means.npy``/``stds.npy``."""

    keys = CALO_KEYS + ["extra_dims"]


class CaloHadStandardizeUsFromFile(DictStandardizeUs):
    """Per-component standardization of the u's by (std + 1), as the
    reference does, in the run dir's ``means_u.npy``/``stds_u.npy``."""

    std_offset = 1


class CaloHadPreprocessConds:
    """Min-max scale of the incident energy (GeV, default [10, 90])."""

    def __init__(self, scale_E=(1e1, 9e1)):
        self.cond_transform = True
        self.lo, self.hi = float(scale_E[0]), float(scale_E[1])

    def __call__(self, data_dict, rev=False, rank=0):
        e = data_dict["energy"]
        if rev:
            data_dict["energy"] = e * (self.hi - self.lo) + self.lo
        else:
            data_dict["energy"] = (e - self.lo) / (self.hi - self.lo)
        return data_dict


class CaloHadScaleTotalEnergy(DictScaleTotalEnergy):
    """u_0 scaled by a factor."""


class CaloHadExclusiveLogitTransform(DictExclusiveLogit):
    """(Rescaled) logit of the ECal and HCal voxels and the u's."""

    keys = CALO_KEYS + ["extra_dims"]


class CaloHadCutValues(DictCutValues):
    """The reverse-only cut in the normalized space."""

    keys = CALO_KEYS


class CaloHadNormalizeByElayer:
    """The joint u's: each layer of each calorimeter normalized to unit
    sum, and one u-vector over all layers (u_0 = E_tot / E_inc, u_i = E_i /
    E_{>=i}); the reverse rebuilds the layer energies recursively, ECal
    taking the first layers' and HCal the last."""

    def __init__(self, cut=0.0, eps=1.0e-10):
        self.keys = CALO_KEYS
        self.eps = float(eps)
        self.cut = float(cut)

    def __call__(self, data_dict, rev=False, rank=0):
        if rev:
            layer_es = layers_of_ratios(data_dict, "energy")  # (B, L_total)
            for key in self.keys:
                shower = np.array(data_dict[key])
                l_here = shower.shape[1]
                shower = shower / (shower.sum(axis=(-1, -2), keepdims=True) + self.eps)
                if self.cut > 0.0:
                    shower[shower <= self.cut] = 0.0
                es = layer_es[:, :l_here] if key == "ecal" else layer_es[:, -l_here:]
                data_dict[key] = shower * es[:, :, None, None]
        else:
            all_layer_es = []
            for key in self.keys:
                shower = np.array(data_dict[key])
                layer_es = shower.sum(axis=(-1, -2))  # (B, L)
                data_dict[key] = shower / (layer_es[:, :, None, None] + self.eps)
                all_layer_es.append(layer_es)
            layer_es = np.concatenate(all_layer_es, axis=1)
            data_dict["extra_dims"] = ratios_of_layers(layer_es, data_dict["energy"], self.eps)
        return data_dict


class Reshape:
    """Per calorimeter: the forward flattens to (B, 1, voxels), the reverse
    restores the 3-D grids of ``dict_shape``."""

    def __init__(self, dict_shape):
        self.dict_shape = {k: tuple(v) for k, v in dict_shape.items()}
        self.keys = CALO_KEYS

    def __call__(self, data_dict, rev=False, rank=0):
        for key in self.keys:
            shape = self.dict_shape[key]
            if rev:
                data_dict[key] = np.reshape(data_dict[key], (-1, *shape))
            else:
                data_dict[key] = np.reshape(data_dict[key], (-1, 1, int(np.prod(shape))))
        return data_dict


def sum_pool(x, kernel):
    """(B, L, H, W) summed over non-overlapping ``kernel`` windows."""
    b, l, h, w = x.shape
    kl, kh, kw = kernel
    return x.reshape(b, l // kl, kl, h // kh, kh, w // kw, kw).sum(axis=(2, 4, 6))


class SumPool3dDownScale:
    """The irreversible sum-pool downsample of one calorimeter's grid."""

    def __init__(self, calo="ecal", kernel=(3, 12, 12)):
        self.calo = calo
        self.kernel = tuple(int(k) for k in kernel)

    def __call__(self, data_dict, rev=False, rank=0):
        if rev:
            return data_dict
        data_dict[self.calo] = sum_pool(np.asarray(data_dict[self.calo]), self.kernel)
        return data_dict


class AddLEMURSConditions:
    """Fixed (theta, phi, label) conditions appended for a LEMURS backbone's
    fine-tuning."""

    def __init__(self, theta=0.5, phi=0.5, label=(0.2, 0.2, 0.2, 0.2, 0.2)):
        self.theta = float(theta)
        self.phi = float(phi)
        self.label = list(label)
        self.n_conds = 2 + len(self.label)

    def __call__(self, data_dict, rev=False, rank=0):
        if rev:
            return data_dict
        n = len(np.atleast_1d(data_dict["energy"]))
        data_dict["additional_conds"] = np.tile(
            np.asarray([self.theta, self.phi] + self.label, np.float32), (n, 1))
        return data_dict


STEPS = {cls.__name__: cls for cls in (
    CaloHadGlobalStandardizeFromFile, CaloHadStandardizeUsFromFile, CaloHadPreprocessConds,
    CaloHadScaleTotalEnergy, CaloHadExclusiveLogitTransform, CaloHadCutValues,
    CaloHadNormalizeByElayer, Reshape, SumPool3dDownScale, AddLEMURSConditions)}


def build_pipeline(transforms_cfg, run_dir):
    """The ordered steps of ``cfg.data.transforms``; a ``*FromFile`` step
    takes ``run_dir`` as ``model_dir`` only where the mapping leaves it
    unset (a fine-tuning run may reuse a pretrained run's statistics)."""
    return build_steps(STEPS, transforms_cfg, run_dir, keep_model_dir=True)

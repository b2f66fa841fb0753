"""The dict-protocol transform pipelines of the CaloGAN, LEMURS and
CaloHadronic families: each step maps a dict of numpy arrays to a dict and
is reversed by ``rev=True``; a step skips the keys its dict lacks, so a
u-only ``{"extra_dims": u}`` dict goes through the same steps as a whole
event.

The steps the families share are written once here over a ``keys`` list;
each family subclasses them under the class names its configs and the
chain's twin registry use.
"""

from __future__ import annotations

import os

import numpy as np

from vit4hep_tpu_torch.data.calochallenge.transforms import logit


def build_steps(steps, transforms_cfg, run_dir, keep_model_dir=False):
    """The step instances of a ``data.transforms`` mapping, in order, from
    ``steps`` (class name -> class). The ``*FromFile`` steps get ``run_dir``
    as ``model_dir``: always (CaloGAN, LEMURS), or only where the mapping
    leaves it unset (``keep_model_dir``: CaloHadronic)."""
    out = []
    for name, kwargs in transforms_cfg.items():
        if name not in steps:
            raise ValueError(f"unknown transform {name}")
        kwargs = dict(kwargs) if kwargs else {}
        if "FromFile" in name and not (keep_model_dir and kwargs.get("model_dir") is not None):
            kwargs["model_dir"] = run_dir
        out.append(steps[name](**kwargs))
    return out


def reverse_until(steps, data_dict, stop, u_only=False):
    """``data_dict`` through ``steps`` reversed, in reverse order, down to
    (not including) the step of class name ``stop``; with ``u_only`` only
    the steps that carry ``u_transform``."""
    for fn in steps[::-1]:
        if fn.__class__.__name__ == stop:
            break
        if not u_only or hasattr(fn, "u_transform"):
            data_dict = fn(data_dict, rev=True)
    return data_dict


class DictGlobalStandardize:
    """One mean/std over the non-saturated logits of ``keys``, in the run
    dir's ``means.npy``/``stds.npy``; fitted on the first forward call when
    they are missing."""

    keys = ()

    def __init__(self, model_dir, eps=1.0e-6):
        self.model_dir = str(model_dir)
        self.mean_path = os.path.join(self.model_dir, "means.npy")
        self.std_path = os.path.join(self.model_dir, "stds.npy")
        eps = float(eps)
        self.eps = float(np.log(eps / (1 - eps)))  # logit(eps)
        self.u_transform = True
        try:
            self.mean = float(np.load(self.mean_path))
            self.std = float(np.load(self.std_path))
            self.written = True
        except FileNotFoundError:
            self.written = False

    @staticmethod
    def values(data_dict, keys):
        """The values the statistics are fitted on, in the reference's order
        (the order sets the float sums)."""
        return np.concatenate([np.ravel(data_dict[k]) for k in keys])

    def __call__(self, data_dict, rev=False, rank=0):
        keys = [k for k in self.keys if k in data_dict]
        if rev:
            for key in keys:
                data_dict[key] = data_dict[key] * self.std + self.mean
            return data_dict
        if not self.written:
            flat = self.values(data_dict, keys)
            mask = (flat > self.eps) & (flat < -self.eps)
            self.mean = float(flat[mask].mean())
            self.std = float(flat[mask].std(ddof=1))
            if rank == 0:
                np.save(self.mean_path, np.float32(self.mean))
                np.save(self.std_path, np.float32(self.std))
            self.written = True
        for key in keys:
            data_dict[key] = (data_dict[key] - self.mean) / self.std
        return data_dict


class DictStandardizeUs:
    """Per-component standardization of the u's by (std + ``std_offset``),
    in the run dir's ``means_u.npy``/``stds_u.npy``."""

    std_offset = 0

    def __init__(self, n_us, model_dir):
        self.model_dir = str(model_dir)
        self.mean_us_path = os.path.join(self.model_dir, "means_u.npy")
        self.std_us_path = os.path.join(self.model_dir, "stds_u.npy")
        self.n_us = int(n_us)
        self.u_transform = True
        try:
            self.mean_u = np.load(self.mean_us_path)
            self.std_u = np.load(self.std_us_path)
            self.written = True
        except FileNotFoundError:
            self.written = False

    def __call__(self, data_dict, rev=False, rank=0):
        us = data_dict["extra_dims"]
        if rev:
            data_dict["extra_dims"] = us * (self.std_u + self.std_offset) + self.mean_u
            return data_dict
        if not self.written:
            self.mean_u = us.mean(0)
            self.std_u = us.std(0, ddof=1)
            if rank == 0:
                np.save(self.mean_us_path, self.mean_u)
                np.save(self.std_us_path, self.std_u)
            self.written = True
        data_dict["extra_dims"] = (us - self.mean_u) / (self.std_u + self.std_offset)
        return data_dict


class DictScaleTotalEnergy:
    """u_0 = E_tot / E_inc scaled by a factor."""

    def __init__(self, factor):
        self.factor = float(factor)
        self.u_transform = True

    def __call__(self, data_dict, rev=False, rank=0):
        us = np.array(data_dict["extra_dims"])
        us[..., 0] = us[..., 0] / self.factor if rev else us[..., 0] * self.factor
        data_dict["extra_dims"] = us
        return data_dict


class DictExclusiveLogit:
    """(Rescaled) logit of ``keys``."""

    keys = ()

    def __init__(self, delta, rescale=False):
        self.delta = float(delta)
        self.rescale = bool(rescale)
        self.u_transform = True

    def __call__(self, data_dict, rev=False, rank=0):
        for key in [k for k in self.keys if k in data_dict]:
            x = data_dict[key]
            if rev:
                if self.rescale:
                    data_dict[key] = logit(x, alpha=self.delta, inv=True)
                else:
                    data_dict[key] = 1.0 / (1.0 + np.exp(-x))
            elif self.rescale:
                data_dict[key] = logit(x, alpha=self.delta)
            else:
                xc = np.clip(x, self.delta, 1 - self.delta)
                data_dict[key] = np.log(xc / (1 - xc))
        return data_dict


class DictCutValues:
    """The reverse-only cut of ``keys`` in the normalized space."""

    keys = ()

    def __init__(self, cut=0.0):
        self.cut = float(cut)

    def __call__(self, data_dict, rev=False, rank=0):
        if rev and self.cut:
            for key in self.keys:
                shower = np.array(data_dict[key])
                shower[shower <= self.cut] = 0.0
                data_dict[key] = shower
        return data_dict


def ratios_of_layers(layer_es, e_inc, eps):
    """The u's of (B, L) layer energies: u_0 = E_tot / E_inc and u_i =
    E_i / E_{>=i}, the tail sums taken right to left."""
    u_0 = layer_es.sum(axis=1, keepdims=True) / (np.asarray(e_inc) + eps)
    remaining = np.cumsum(layer_es[:, ::-1], axis=1)[:, ::-1]
    return np.concatenate([u_0, layer_es[:, :-1] / (remaining[:, :-1] + eps)], axis=1)


def layers_of_ratios(data_dict, energy_key):
    """The (B, L) layer energies that the u's of ``data_dict`` give, rebuilt
    recursively; the ratios u_1.. are clipped to [0, 1] in the dict, as the
    reference saves them."""
    us = np.array(data_dict["extra_dims"])
    us[:, 1:] = np.clip(us[:, 1:], 0.0, 1.0)
    data_dict["extra_dims"] = us
    layer_es = []
    remaining = np.asarray(data_dict[energy_key]).reshape(-1) * us[:, 0]
    for i in range(us.shape[1] - 1):
        e_i = remaining * us[:, i + 1]
        layer_es.append(e_i)
        remaining = remaining - e_i
    layer_es.append(remaining)
    return np.stack(layer_es, axis=1)

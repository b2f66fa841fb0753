"""Invertible CaloChallenge preprocessing steps of the ds1-ds3 paths (port of
``vit4hep_tpu/data/calochallenge/transforms.py``; numpy, on the host).

Every step keeps the JAX package's class name, constructor keywords and
protocol ``__call__(shower, energy, rev=False, rank=0) -> (shower,
energy)``, so the ``data.transforms`` mappings of the shared configs resolve
unchanged through :func:`build_pipeline`. The marker attributes
``u_transform`` and ``cond_transform`` select the steps applied to sampled
u-vectors and to conditions at generation time.

The ``*FromFile`` standardizations load the statistics that an earlier
training wrote into the run directory; when there are none, the first
forward call fits them on its input (``ddof=1``; ``exclude_zeros`` drops the
saturated logits) and rank 0 writes ``means.npy``/``stds.npy`` (or
``means_u.npy``/``stds_u.npy``), as training does in the JAX package.
``SelectiveUniformNoise`` (the cINN chains) draws its training noise from
an explicit numpy ``Generator``. ``AddAngularBins`` pads ds1's irregular
alpha binning to a regular grid. ``ScaleVoxels`` scales the voxels by a
constant; ``AddLEMURSConditions`` appends fixed (theta, phi, one-hot label)
columns to the condition, for the shape model fine-tuned from a LEMURS
backbone (``calochallenge_lemurstods2_ft``).
"""
from __future__ import annotations

import os

import numpy as np

from vit4hep_tpu_torch.data.xml_handler import XMLHandler


def logit(array, alpha=1.0e-6, inv=False):
    """Regularized logit, or its inverse."""
    if inv:
        z = 1.0 / (1.0 + np.exp(-array))
        return (z - alpha) / (1 - 2 * alpha)
    z = array * (1 - 2 * alpha) + alpha
    return np.log(z / (1 - z))


def _load_stats(model_dir, *names):
    """The saved statistics, or None when training has not written them yet."""
    paths = [os.path.join(model_dir, n) for n in names]
    if not all(os.path.exists(p) for p in paths):
        return None
    return [np.load(p) for p in paths]


def _unfitted(model_dir, *names):
    return FileNotFoundError(f"no fitted statistics {list(names)} in {model_dir}: training "
                             "fits them on its first forward call")


class GlobalStandardizeFromFile:
    """Scalar standardization with the run dir's ``means.npy``/``stds.npy``,
    fitted on the first forward call when they are missing."""

    def __init__(self, model_dir, exclude_zeros=True, eps=1.0e-6):
        self.model_dir = model_dir
        self.u_transform = True
        self.exclude_zeros = exclude_zeros
        self.eps = float(np.log(eps / (1 - eps)))  # logit(eps)
        stats = _load_stats(model_dir, "means.npy", "stds.npy")
        self.written = stats is not None
        if self.written:
            self.mean, self.std = stats

    def __call__(self, shower, energy, rev=False, rank=0):
        if rev:
            if not self.written:
                raise _unfitted(self.model_dir, "means.npy", "stds.npy")
            return shower * self.std + self.mean, energy
        if not self.written:
            if self.exclude_zeros:  # |x| < -logit(eps): the logits that did not saturate
                mask = (shower > self.eps) & (shower < -self.eps)
            else:
                mask = np.ones_like(shower, dtype=bool)
            vals = shower[mask]
            self.mean = vals.mean()
            self.std = vals.std(ddof=1)
            if rank == 0:
                np.save(os.path.join(self.model_dir, "means.npy"), np.asarray(self.mean))
                np.save(os.path.join(self.model_dir, "stds.npy"), np.asarray(self.std))
            self.written = True
        return (shower - self.mean) / self.std, energy


class StandardizeUsFromFile:
    """Per-dimension standardization of the trailing ``n_us`` u-features with
    the run dir's ``means_u.npy``/``stds_u.npy``, fitted on the first
    forward call when they are missing."""

    def __init__(self, n_us, model_dir):
        self.model_dir = model_dir
        self.n_us = n_us
        self.u_transform = True
        stats = _load_stats(model_dir, "means_u.npy", "stds_u.npy")
        self.written = stats is not None
        if self.written:
            self.mean_u, self.std_u = stats

    def __call__(self, shower, energy, rev=False, rank=0):
        us, voxels = shower[:, -self.n_us:], shower[:, :-self.n_us]
        if rev:
            if not self.written:
                raise _unfitted(self.model_dir, "means_u.npy", "stds_u.npy")
            trafo = us * self.std_u + self.mean_u
        else:
            if not self.written:
                self.mean_u = us.mean(0)
                self.std_u = us.std(0, ddof=1)
                if rank == 0:
                    np.save(os.path.join(self.model_dir, "means_u.npy"), np.asarray(self.mean_u))
                    np.save(os.path.join(self.model_dir, "stds_u.npy"), np.asarray(self.std_u))
                self.written = True
            trafo = (us - self.mean_u) / self.std_u
        return np.concatenate((voxels, trafo), axis=1), energy


class SelectDims:
    """Keep features in [start, end), negative indices allowed; the reverse
    is a no-op."""

    def __init__(self, start, end):
        self.indices = np.arange(start, end)

    def __call__(self, shower, energy, rev=False, rank=0):
        return (shower if rev else shower[..., self.indices]), energy


class AddFeaturesToCond:
    """Move the features past ``split_index`` into the condition vector."""

    def __init__(self, split_index):
        self.split_index = split_index

    def __call__(self, x, c, rev=False, rank=0):
        if rev:
            return np.concatenate([x, c[:, :-1]], axis=1), c[:, -1:]
        return x[:, :self.split_index], np.concatenate([x[:, self.split_index:], c], axis=1)


class LogEnergy:
    def __init__(self, alpha=0.0):
        self.alpha = alpha
        self.cond_transform = True

    def __call__(self, shower, energy, rev=False, rank=0):
        if rev:
            return shower, np.exp(energy) - self.alpha
        return shower, np.log(energy + self.alpha)


class ScaleVoxels:
    def __init__(self, factor):
        self.factor = factor

    def __call__(self, shower, energy, rev=False, rank=0):
        return (shower / self.factor if rev else shower * self.factor), energy


class ScaleTotalEnergy:
    """Scale only u_0 = E_tot / E_inc, the column ``-n_layers``."""

    def __init__(self, factor, n_layers=45):
        self.factor = factor
        self.n_layers = n_layers
        self.u_transform = True

    def __call__(self, shower, energy, rev=False, rank=0):
        shower = shower.copy()
        if rev:
            shower[..., -self.n_layers] /= self.factor
        else:
            shower[..., -self.n_layers] *= self.factor
        return shower, energy


class ScaleEnergy:
    """Min-max scale the (log-)incident energy to [0, 1]."""

    def __init__(self, e_min, e_max):
        self.e_min = e_min
        self.e_max = e_max
        self.cond_transform = True

    def __call__(self, shower, energy, rev=False, rank=0):
        if rev:
            return shower, energy * (self.e_max - self.e_min) + self.e_min
        return shower, (energy - self.e_min) / (self.e_max - self.e_min)


class ExclusiveLogitTransform:
    """Logit transform, sparing the columns in ``exclusions``."""

    def __init__(self, delta, exclusions=None, rescale=False):
        self.delta = delta
        self.exclusions = exclusions
        self.rescale = rescale
        self.u_transform = True

    def __call__(self, shower, energy, rev=False, rank=0):
        if self.rescale:
            transformed = logit(shower, alpha=self.delta, inv=rev)
        elif rev:
            transformed = 1.0 / (1.0 + np.exp(-shower))
        else:
            clipped = np.clip(shower, self.delta, 1 - self.delta)
            transformed = np.log(clipped / (1 - clipped))
        if self.exclusions is not None:
            transformed[..., self.exclusions] = shower[..., self.exclusions]
        return transformed, energy


class SelectiveUniformNoise:
    """Forward (training): U(a, b) noise added to every value other than 1,
    sparing the ``exclusions`` columns, drawn from ``rng`` (a numpy
    ``Generator``; an unseeded one when none is given). Reverse: with
    ``cut``, the values below ``b`` outside the exclusions become 0. No
    ``u_transform`` marker: the u mapping between the two models skips it."""

    def __init__(self, a, b, exclusions=None, cut=False, rng=None):
        self.a = a
        self.b = b
        self.exclusions = exclusions
        self.cut = cut
        self.rng = np.random.default_rng() if rng is None else rng

    def __call__(self, shower, energy, rev=False, rank=0):
        shower = shower.copy()
        if rev:
            mask = shower < self.b
            if self.exclusions:
                mask[:, self.exclusions] = False
            if self.cut:
                shower[mask] = 0.0
        else:
            noise = self.rng.uniform(self.a, self.b, size=shower.shape).astype(shower.dtype)
            if self.exclusions:
                noise[:, self.exclusions] = 0.0
            mask = shower != 1
            shower[mask] = (shower + noise)[mask]
        return shower, energy


class CutValues:
    """Reverse only: zero the voxels at or below ``cut`` in normalized space,
    sparing the trailing ``n_layers`` u-features."""

    def __init__(self, cut=0.0, n_layers=45):
        self.cut = cut
        self.n_layers = n_layers

    def __call__(self, shower, energy, rev=False, rank=0):
        if rev and self.cut:
            shower = shower.copy()
            mask = shower <= self.cut
            mask[:, -self.n_layers:] = False
            shower[mask] = 0.0
        return shower, energy


class Reshape:
    """(B, prod(shape)) <-> (B, *shape)."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def __call__(self, shower, energy, rev=False, rank=0):
        if rev:
            return shower.reshape(-1, int(np.prod(self.shape))), energy
        return shower.reshape(-1, *self.shape), energy


class NormalizeByElayer:
    """The u-space construction: each layer normalized to unit energy, plus
    the energy-ratio features u_0 = E_tot / E_inc and u_i = E_{i-1} /
    E_{>=i-1}. The reverse rebuilds the layer energies from the u's and
    rescales the normalized voxels.

    The shipped configs pass the XML path as ``ptype`` and the particle name
    as ``xml_file``; the keywords are read that way, as in the JAX package.
    """

    def __init__(self, ptype, xml_file, cut=0.0, eps=1.0e-10):
        self.eps = eps
        self.cut = cut
        self.layer_boundaries = np.unique(XMLHandler(xml_file, ptype).GetBinEdges())
        self.n_layers = len(self.layer_boundaries) - 1
        self.layer_sizes = np.diff(self.layer_boundaries)

    def _layer_sums(self, voxels):
        return np.add.reduceat(voxels, self.layer_boundaries[:-1], axis=1)

    def _per_voxel(self, per_layer):
        return np.repeat(per_layer, self.layer_sizes, axis=1)

    def __call__(self, shower, energy, rev=False, rank=0):
        if not rev:
            layer_es = self._layer_sums(shower)
            voxels = shower / self._per_voxel(layer_es + self.eps)
            rest = np.cumsum(layer_es[:, ::-1], axis=1)[:, ::-1]  # E_{>=i}
            u0 = rest[:, :1] / energy.reshape(-1, 1)
            ui = layer_es[:, :-1] / (rest[:, :-1] + self.eps)
            return np.concatenate((voxels, u0, ui), axis=1), energy

        us = shower[:, -self.n_layers:].copy()
        us[:, 1:] = np.clip(us[:, 1:], 0.0, 1.0)
        voxels = shower[:, :-self.n_layers]
        # R_0 = E_inc u_0; E_i = R_i u_{i+1}; R_{i+1} = R_i (1 - u_{i+1}); E_{L-1} = R_{L-1}
        total = energy.reshape(-1, 1) * us[:, :1]
        remaining = np.concatenate([total, total * np.cumprod(1.0 - us[:, 1:], axis=1)], axis=1)
        layer_es = np.empty((shower.shape[0], self.n_layers), shower.dtype)
        layer_es[:, :-1] = remaining[:, :-1] * us[:, 1:]
        layer_es[:, -1] = remaining[:, -1]
        layer_norm = voxels / self._per_voxel(self._layer_sums(voxels) + self.eps)
        layer_norm[layer_norm <= self.cut] = 0.0
        return layer_norm * self._per_voxel(layer_es), energy


class AddAngularBins:
    """Pads each layer's alpha axis to a regular count: a layer of
    ``num_bins`` alpha bins grows to ``num_bins + add_bins // num_bins - 1``,
    the zeros split around its bins (the extra one on the right). The
    reverse keeps the largest value of each group of ``add_bins //
    num_bins`` slots. The u-features after the voxels pass through.

    The shipped configs pass the XML path as ``ptype`` and the particle name
    as ``xml_filename``; the keywords are read that way, as in the JAX
    package."""

    def __init__(self, xml_filename, ptype, num_bins, add_bins):
        self.layer_boundaries = np.unique(XMLHandler(xml_filename, ptype).GetBinEdges())
        self.num_bins = np.array(num_bins)
        self.add_bins = np.array(add_bins)
        self.n_voxels = int(self.layer_boundaries[-1])
        new_alpha = self.num_bins + self.add_bins // self.num_bins - 1
        new_sizes = np.diff(self.layer_boundaries) // self.num_bins * new_alpha
        self.new_layer_boundaries = np.concatenate([[0], np.cumsum(new_sizes)]).astype(int)

    def __call__(self, shower, energy, rev=False, rank=0):
        b = shower.shape[0]
        parts = []
        if rev:
            n_vox, bounds = int(self.new_layer_boundaries[-1]), self.new_layer_boundaries
        else:
            n_vox, bounds = self.n_voxels, self.layer_boundaries
        voxels, us = shower[:, :n_vox], shower[:, n_vox:]
        for i in range(len(bounds) - 1):
            alpha = self.num_bins[i]
            layer = voxels[:, bounds[i]:bounds[i + 1]]
            if rev:
                layer = layer.reshape(b, -1, alpha, self.add_bins[i] // alpha).max(-1)
            else:
                extra = self.add_bins[i] // alpha - 1
                layer = np.pad(layer.reshape(b, -1, alpha),
                               ((0, 0), (0, 0), (extra // 2, extra - extra // 2)))
            parts.append(layer.reshape(b, -1))
        return np.concatenate((np.concatenate(parts, axis=-1), us), axis=-1).astype(
            shower.dtype), energy


class AddLEMURSConditions:
    """Append the fixed (theta, phi, label) columns of a LEMURS backbone's
    conditioning to every condition; the reverse cuts them off."""

    def __init__(self, theta=0.5, phi=0.5, label=(1, 0, 0, 0, 0)):
        self.theta = theta
        self.phi = phi
        self.label = list(label)
        self.n_conds = 2 + len(self.label)

    def __call__(self, shower, energy, rev=False, rank=0):
        if rev:
            return shower, energy[:, :-self.n_conds]
        extra = np.tile(np.asarray([self.theta, self.phi] + self.label, dtype=energy.dtype),
                        (energy.shape[0], 1))
        return shower, np.concatenate((energy, extra), axis=1)


_STEPS = {cls.__name__: cls for cls in (
    GlobalStandardizeFromFile, StandardizeUsFromFile, SelectDims, AddFeaturesToCond,
    LogEnergy, ScaleTotalEnergy, ScaleEnergy, ExclusiveLogitTransform, SelectiveUniformNoise,
    CutValues, Reshape, NormalizeByElayer, AddAngularBins, ScaleVoxels, AddLEMURSConditions)}


def build_pipeline(transforms_cfg, run_dir: str):
    """The step instances of a ``data.transforms`` mapping, in order; the
    ``*FromFile`` steps read their statistics from ``run_dir`` unless the
    mapping names a ``model_dir``."""
    steps = []
    for name, kwargs in transforms_cfg.items():
        if name not in _STEPS:
            raise ValueError(f"transform {name} not implemented")
        kwargs = dict(kwargs or {})
        if "FromFile" in name and kwargs.get("model_dir") is None:
            kwargs["model_dir"] = run_dir
        steps.append(_STEPS[name](**kwargs))
    return steps


def apply_pipeline(steps, shower, energy, rev=False, rank=0):
    """Apply a chain of steps, in reverse order when ``rev``."""
    for fn in reversed(steps) if rev else steps:
        shower, energy = fn(shower, energy, rev=rev, rank=rank)
    return shower, energy

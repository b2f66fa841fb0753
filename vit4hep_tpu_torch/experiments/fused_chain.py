"""Two-stage generation: energy ODE -> u mapping -> shape ODE (port of
``vit4hep_tpu/experiments/fused_chain.py``).

The u mapping between the two models runs on the device: each u-transform
has a tensor twin here, registered by class name (the CaloChallenge array
steps, and the dict steps of CaloGAN, LEMURS and CaloHadronic, whose twin
is the step's action on a u-only ``{"extra_dims": u}`` dict, as the staged
``sample_us`` applies it). A chain with a transform without a twin raises
:class:`UnsupportedTransform`.
"""

from __future__ import annotations

import numpy as np
import torch


class UnsupportedTransform(Exception):
    """A u-transform in the chain has no registered device twin."""


def _const(a, like):
    return torch.as_tensor(np.asarray(a, np.float32), device=like.device)


def _standardize(mean, std, rev):
    """u -> (u - mean) / std, or its reverse, elementwise over the u's."""
    mean, std = np.asarray(mean, np.float32), np.asarray(std, np.float32)
    if rev:
        return lambda u: u * _const(std, u) + _const(mean, u)
    return lambda u: (u - _const(mean, u)) / _const(std, u)


def _twin_global_standardize(t, rev):
    return _standardize(t.mean, t.std, rev)


def _twin_standardize_us(t, rev):
    mean, std = np.asarray(t.mean_u, np.float32), np.asarray(t.std_u, np.float32)
    n_us = int(t.n_us)

    def fwd(u):
        us, vox = u[:, -n_us:], u[:, :-n_us]
        return torch.cat([vox, (us - _const(mean, u)) / _const(std, u)], dim=1)

    def irev(u):
        us, vox = u[:, -n_us:], u[:, :-n_us]
        return torch.cat([vox, us * _const(std, u) + _const(mean, u)], dim=1)

    return irev if rev else fwd


def _twin_scale_total_energy(t, rev):
    factor, col = float(t.factor), -int(t.n_layers)

    def apply(u, f):
        u = u.clone()
        u[..., col] *= f
        return u

    return (lambda u: apply(u, 1.0 / factor)) if rev else (lambda u: apply(u, factor))


def _twin_exclusive_logit(t, rev):
    delta = float(t.delta)
    exclusions = None if t.exclusions is None else list(np.asarray(t.exclusions, np.int64))
    rescale = bool(t.rescale)

    def keep_excluded(out, u):
        if exclusions is not None:
            out[..., exclusions] = u[..., exclusions]
        return out

    def fwd(u):
        if rescale:
            z = u * (1 - 2 * delta) + delta
        else:
            z = torch.clamp(u, delta, 1 - delta)
        return keep_excluded(torch.log(z / (1 - z)), u)

    def irev(u):
        z = torch.sigmoid(u)
        return keep_excluded((z - delta) / (1 - 2 * delta) if rescale else z, u)

    return irev if rev else fwd


def _twin_standardize_us_dict(t, rev):
    """LEMURS's per-component standardization over the whole u array."""
    return _standardize(t.mean_u, t.std_u, rev)


def _twin_standardize_us_plus1(t, rev):
    """CaloHadronic's standardization by (std + 1)."""
    return _standardize(t.mean_u, np.asarray(t.std_u, np.float32) + np.float32(1.0), rev)


def _twin_scale_u0(t, rev):
    """The dict steps' ScaleTotalEnergy: u_0 is column 0."""
    factor = float(t.factor)

    def apply(u):
        u = u.clone()
        u[..., 0] = u[..., 0] / factor if rev else u[..., 0] * factor
        return u

    return apply


def _twin_elementwise_logit(t, rev):
    """The dict steps' (rescaled) logit on the u's: elementwise, no
    excluded columns (CaloGAN's step keeps ``exclusions`` and never applies
    it)."""
    delta, rescale = float(t.delta), bool(t.rescale)

    def fwd(u):
        z = u * (1 - 2 * delta) + delta if rescale else torch.clamp(u, delta, 1 - delta)
        return torch.log(z / (1 - z))

    def irev(u):
        z = torch.sigmoid(u)
        return (z - delta) / (1 - 2 * delta) if rescale else z

    return irev if rev else fwd


# class name -> twin(step, rev) -> (u -> u): every family's step of the
# same name and arithmetic shares one twin
_REGISTRY = {
    "GlobalStandardizeFromFile": _twin_global_standardize,
    "StandardizeUsFromFile": _twin_standardize_us,
    "ScaleTotalEnergy": _twin_scale_total_energy,
    "ExclusiveLogitTransform": _twin_exclusive_logit,
    "LEMURSGlobalStandardizeFromFile": _twin_global_standardize,
    "LEMURSStandardizeUsFromFile": _twin_standardize_us_dict,
    "LEMURSScaleTotalEnergy": _twin_scale_u0,
    "LEMURSExclusiveLogitTransform": _twin_elementwise_logit,
    "CaloHadGlobalStandardizeFromFile": _twin_global_standardize,
    "CaloHadStandardizeUsFromFile": _twin_standardize_us_plus1,
    "CaloHadScaleTotalEnergy": _twin_scale_u0,
    "CaloHadExclusiveLogitTransform": _twin_elementwise_logit,
    "GlobalStandardizeFromFileGAN": _twin_global_standardize,
    "ExclusiveLogitTransformGAN": _twin_elementwise_logit,
}


def _twin(t, rev):
    name = type(t).__name__
    if name not in _REGISTRY:
        raise UnsupportedTransform(f"no device twin registered for u-transform {name}")
    try:
        return _REGISTRY[name](t, rev)
    except AttributeError as e:
        # a *FromFile step whose statistics were never written: the staged
        # path fits them on the fly, so the chain reports it as unsupported
        raise UnsupportedTransform(f"u-transform {name} has no fitted statistics ({e})") from e


def chain_fingerprint(energy_transforms, shape_transforms) -> str:
    """Digest of the u-chain's transform state: class names and fitted
    constants, with the list each step sits in. A cached generator bakes
    the constants in when it is built, so keying the cache on this digest
    rebuilds it after a refit or a reload."""
    import hashlib

    h = hashlib.sha1()
    # "|" keeps the list placement in the key: a step in the energy list runs
    # in reverse, the same step in the shape list forward
    for t in list(energy_transforms) + ["|"] + list(shape_transforms):
        if not hasattr(t, "u_transform"):
            if isinstance(t, str) and t == "|":
                h.update(b"|")
            continue
        h.update(type(t).__name__.encode())
        for attr in ("mean", "std", "mean_u", "std_u", "factor", "delta", "rescale", "n_us",
                     "n_layers", "exclusions", "written"):
            v = getattr(t, attr, None)
            if v is None:
                continue
            h.update(attr.encode())
            h.update(np.asarray(v).tobytes())
    return h.hexdigest()


def device_u_chain(energy_transforms, shape_transforms):
    """The on-device u mapping: the energy model's u-transform steps in
    reverse, then the shape model's in forward order. A step counts when it
    has the ``u_transform`` attribute (``hasattr``, not its truth value), as
    in the staged path."""
    fns = [_twin(t, rev=True) for t in list(energy_transforms)[::-1] if hasattr(t, "u_transform")]
    fns += [_twin(t, rev=False) for t in shape_transforms if hasattr(t, "u_transform")]

    def apply(u):
        for f in fns:
            u = f(u)
        return u

    return apply


def make_fused_generate(shape_model, energy_model, energy_transforms, shape_transforms,
                        u_position="first", energy_cond_width=None):
    """``generate(cond, generator=None, noise=None) -> (shower, full_cond)``
    for the TRANSFORMED condition ``cond``; the shower is in the shape
    model's training basis. Each of the two models is a CFM or a cINN.
    ``noise`` is ``(energy_noise, shape_noise)`` when the caller supplies
    the noise of both stages (a CFM's initial ODE state ``x_T``, in token
    shape for a patching model, or a cINN's latent ``z`` in x shape);
    otherwise both are drawn from ``generator``, energy first.

    The condition layout of each family's staged ``sample_n``:
    ``u_position="first"`` gives ``full_cond = [u | cond]`` (CaloChallenge,
    LEMURS with cond = [E, theta, phi | labels], CaloHadronic),
    ``"last"`` gives ``[cond | u]`` (CaloGAN); ``energy_cond_width=k`` feeds
    the energy model only the first k columns of ``cond`` (LEMURS: E,
    theta, phi)."""
    if u_position not in ("first", "last"):
        raise ValueError(f"u_position must be 'first' or 'last', got {u_position!r}")
    u_map = device_u_chain(energy_transforms, shape_transforms)

    def generate(cond, generator=None, noise=None):
        x_u, x_s = (None, None) if noise is None else noise
        e_cond = cond if energy_cond_width is None else cond[:, :energy_cond_width]
        # the noise is sample_batch's third argument in both families (a
        # CFM's x_T, a cINN's z), for the energy model as for the shape model
        u = u_map(energy_model.sample_batch(e_cond, generator, x_u))
        full_cond = torch.cat([u, cond] if u_position == "first" else [cond, u], dim=1)
        return shape_model.sample_batch(full_cond, generator, x_s), full_cond

    return generate

"""Config surface of the port (counterpart of ``vit4hep_tpu/utils/config.py``).

The shared ``configs/`` tree names ``vit4hep_tpu.models.*`` (and the
reference's own paths) in its ``_target_`` keys. :data:`TARGET_REMAP` maps
every such target that the port has onto ``vit4hep_tpu_torch.*``; a
``vit4hep_tpu.*`` target the port does not have raises instead of importing
the JAX package. :func:`instantiate` works on plain dicts and needs no YAML
parser; :func:`compose` reads the YAML tree through the JAX package's
composer, which needs PyYAML (a CPU-side convenience, not on the card path).
"""

from __future__ import annotations

import importlib

_MODELS = "vit4hep_tpu_torch.models"
_CFM = f"{_MODELS}.cfm.CFM"
_VIT = f"{_MODELS}.vit.ViT"
_ENERGY = f"{_MODELS}.energy_transformer.ParallelTransformer"
_CALO_CFM = f"{_MODELS}.calochallenge.CaloChallengeCFM"

TARGET_REMAP = {
    # the shared configs' own targets
    "vit4hep_tpu.models.cfm.CFM": _CFM,
    "vit4hep_tpu.models.vit.ViT": _VIT,
    "vit4hep_tpu.models.energy_transformer.ParallelTransformer": _ENERGY,
    "vit4hep_tpu.models.calochallenge.CaloChallengeCFM": _CALO_CFM,
    # the reference's paths, as the JAX package maps them
    "models.base_model.CFM": _CFM,
    "nn.vit.ViT": _VIT,
    "nn.vit.ViT2": _VIT,
    "nn.cfm.transformer_cfm.ParallelTransformer": _ENERGY,
    "nn.cfm.mlp_transformer.MLPTransformer2": _ENERGY,
    "experiments.calochallenge.calochallenge_cfm.model.CaloChallengeCFM": _CALO_CFM,
}


def _locate(target: str):
    target = TARGET_REMAP.get(target, target)
    if target.startswith("vit4hep_tpu."):
        raise NotImplementedError(f"{target} is not ported to vit4hep_tpu_torch yet "
                                  "(ROADMAP.md, queue 1)")
    module_name, _, attr = target.rpartition(".")
    return getattr(importlib.import_module(module_name), attr)


def _build(v):
    if isinstance(v, dict):
        return instantiate(v) if "_target_" in v else {k: _build(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_build(x) for x in v]
    return v


def instantiate(cfg: dict, **kwargs):
    """Build the object a config mapping with a ``_target_`` names; nested
    ``_target_`` mappings at any depth are built first."""
    data = dict(cfg)
    target = data.pop("_target_")
    call_kwargs = {k: _build(v) for k, v in data.items()}
    call_kwargs.update(kwargs)
    return _locate(str(target))(**call_kwargs)


def compose(config_path: str, config_name: str, overrides=None) -> dict:
    """Compose a config from the YAML tree into a plain resolved dict."""
    from vit4hep_tpu.utils.config import compose as compose_yaml  # PyYAML, no JAX

    return compose_yaml(config_path, config_name, list(overrides or [])).to_container(
        resolve=True)

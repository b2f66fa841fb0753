"""Config surface of the port (counterpart of ``vit4hep_tpu/utils/config.py``).

The subset of Hydra/OmegaConf semantics the shared ``configs/`` tree uses,
kept to the JAX package's behaviour: defaults-list composition (a config's
own body merges last unless ``_self_`` is listed), ``???`` mandatory values,
lazy ``${a.b}`` interpolation against the root, dotted CLI overrides parsed
with YAML rules (``~key`` deletes, ``group=name`` swaps a defaults group),
and :func:`instantiate` of ``_target_`` nodes.

The configs name ``vit4hep_tpu.models.*`` (and the reference's own paths) in
their ``_target_`` keys. :data:`TARGET_REMAP` maps every such target that the
port has onto ``vit4hep_tpu_torch.*``; a ``vit4hep_tpu.*`` target the port
does not have raises instead of importing the JAX package.

PyYAML is imported inside the functions that read YAML (:func:`compose`,
:meth:`OmegaConf.load`, override parsing), so the package imports on hosts
without it. Writing a config (:meth:`Config.to_yaml`) needs no PyYAML: the
emitter below writes the block-style subset that ``yaml.safe_load`` reads
back to the same values.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
import re
from typing import Any

_MISSING = "???"
_INTERP_RE = re.compile(r"\$\{([^}]+)\}")

_MODELS = "vit4hep_tpu_torch.models"
_CFM = f"{_MODELS}.cfm.CFM"
_VIT = f"{_MODELS}.vit.ViT"
_ENERGY = f"{_MODELS}.energy_transformer.ParallelTransformer"
_CALO_CFM = f"{_MODELS}.calochallenge.CaloChallengeCFM"
_CALO_CFM_DS1 = f"{_MODELS}.calochallenge.CaloChallengeCFM_DS1"
_CALO_CINN = f"{_MODELS}.calochallenge.CaloChallengeCINN"
_CALO_ENERGY_CINN = f"{_MODELS}.calochallenge.CaloChallengeEnergyCINN"
_VIT1D = f"{_MODELS}.vit.ViT1D"
_CALOGAN = f"{_MODELS}.calogan.CaloGANCFM"
_LEMURS = f"{_MODELS}.lemurs.LEMURSCFM"
_CALOHAD = f"{_MODELS}.calohadronic.CaloHadCFM"

TARGET_REMAP = {
    # the shared configs' own targets
    "vit4hep_tpu.models.cfm.CFM": _CFM,
    "vit4hep_tpu.models.vit.ViT": _VIT,
    "vit4hep_tpu.models.energy_transformer.ParallelTransformer": _ENERGY,
    "vit4hep_tpu.models.calochallenge.CaloChallengeCFM": _CALO_CFM,
    "vit4hep_tpu.models.calochallenge.CaloChallengeCFM_DS1": _CALO_CFM_DS1,
    "vit4hep_tpu.models.calochallenge.CaloChallengeCINN": _CALO_CINN,
    "vit4hep_tpu.models.calochallenge.CaloChallengeEnergyCINN": _CALO_ENERGY_CINN,
    "vit4hep_tpu.models.vit.ViT1D": _VIT1D,
    "vit4hep_tpu.models.calogan.CaloGANCFM": _CALOGAN,
    "vit4hep_tpu.models.lemurs.LEMURSCFM": _LEMURS,
    "vit4hep_tpu.models.calohadronic.CaloHadCFM": _CALOHAD,
    # the reference's paths, as the JAX package maps them
    "models.base_model.CFM": _CFM,
    "nn.vit.ViT": _VIT,
    "nn.vit.ViT2": _VIT,
    "nn.cfm.transformer_cfm.ParallelTransformer": _ENERGY,
    "nn.cfm.mlp_transformer.MLPTransformer2": _ENERGY,
    "experiments.calochallenge.calochallenge_cfm.model.CaloChallengeCFM": _CALO_CFM,
    "experiments.calochallenge.calochallenge_cfm.model.CaloChallengeCFM_DS1": _CALO_CFM_DS1,
    "nn.vit.ViT1D": _VIT1D,
    "experiments.calochallenge.calochallenge_cinn.model.CaloChallengeCINN": _CALO_CINN,
    "experiments.calochallenge.model.CaloChallengeCINN": _CALO_CINN,
    "experiments.calochallenge.calochallenge_cinn.model.CaloChallengeEnergyCINN": _CALO_ENERGY_CINN,
    "experiments.calochallenge.model.CaloChallengeEnergy": _CALO_ENERGY_CINN,
    "experiments.calogan.model.CaloGANCFM": _CALOGAN,
    "experiments.lemurs.model.LEMURSCFM": _LEMURS,
    "experiments.calohadronic.model.CaloHadCFM": _CALOHAD,
}


class MissingMandatoryValue(Exception):
    pass


class ConfigAttributeError(AttributeError):
    pass


class Config:
    """Attribute-accessible nested dict with interpolation, mirroring OmegaConf.

    Values equal to ``"???"`` are mandatory: reading them raises
    :class:`MissingMandatoryValue` until they are overridden."""

    def __init__(self, data: dict | None = None, parent: "Config | None" = None):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_parent", parent)
        for k, v in (data or {}).items():
            self._data[k] = self._wrap(v)

    def _wrap(self, v):
        if isinstance(v, Config):
            return Config(v.to_container(resolve=False), parent=self)
        if isinstance(v, dict):
            return Config(v, parent=self)
        if isinstance(v, list):
            return [self._wrap(x) for x in v]
        return v

    def _root(self) -> "Config":
        node = self
        while object.__getattribute__(node, "_parent") is not None:
            node = object.__getattribute__(node, "_parent")
        return node

    def _resolve_value(self, key, v):
        if isinstance(v, str):
            if v == _MISSING:
                raise MissingMandatoryValue(f"Missing mandatory value: {key}")
            if _INTERP_RE.search(v):
                return self._interpolate(v)
        if isinstance(v, list):
            return [self._resolve_value(key, x) for x in v]
        return v

    def _interpolate(self, s: str):
        root = self._root()

        def lookup(path: str):
            node: Any = root
            for part in path.split("."):
                if not isinstance(node, Config):
                    raise ConfigAttributeError(f"Cannot resolve interpolation ${{{path}}}")
                node = node[part]
            return node

        full = _INTERP_RE.fullmatch(s)
        if full:
            return lookup(full.group(1))
        return _INTERP_RE.sub(lambda m: str(lookup(m.group(1))), s)

    def __getattr__(self, key):
        data = object.__getattribute__(self, "_data")
        if key in data:
            return self._resolve_value(key, data[key])
        raise ConfigAttributeError(f"Key '{key}' not found in config")

    def __setattr__(self, key, value):
        self._data[key] = self._wrap(value)

    def __getitem__(self, key):
        return self.__getattr__(key)

    def __setitem__(self, key, value):
        self.__setattr__(key, value)

    def __contains__(self, key):
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def __delitem__(self, key):
        del self._data[key]

    def __deepcopy__(self, memo):
        return Config(self.to_container(resolve=False))

    def get(self, key, default=None):
        if key in self._data:
            try:
                return self._resolve_value(key, self._data[key])
            except MissingMandatoryValue:
                return default
        return default

    def keys(self):
        return self._data.keys()

    def items(self):
        return [(k, self._resolve_value(k, v)) for k, v in self._data.items()]

    def values(self):
        return [self._resolve_value(k, v) for k, v in self._data.items()]

    def setdefault(self, key, value):
        if key not in self._data:
            self[key] = value
        return self[key]

    def merge_with(self, other: "Config | dict"):
        items = other._data.items() if isinstance(other, Config) else other.items()
        for k, v in items:
            if k in self._data and isinstance(self._data[k], Config) \
                    and isinstance(v, (Config, dict)):
                self._data[k].merge_with(v)
            else:
                self._data[k] = self._wrap(v)

    def to_container(self, resolve: bool = False):
        out = {}
        for k, v in self._data.items():
            if isinstance(v, Config):
                out[k] = v.to_container(resolve=resolve)
            elif isinstance(v, list):
                out[k] = [x.to_container(resolve=resolve) if isinstance(x, Config) else x
                          for x in v]
            elif resolve:
                try:
                    out[k] = self._resolve_value(k, v)
                except MissingMandatoryValue:
                    out[k] = None
            else:
                out[k] = v
        return out

    def to_yaml(self, resolve: bool = False) -> str:
        return dump_yaml(self.to_container(resolve=resolve))

    def __repr__(self):
        return f"Config({self.to_container()})"


# ---------------------------------------------------------------------------
# YAML out (no PyYAML needed) and in
# ---------------------------------------------------------------------------
def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r and "." not in r:  # YAML 1.1 reads "1e-05" as a string
            mant, exp = r.split("e")
            r = f"{mant}.0e{exp}"
        return r
    if isinstance(v, (dict, list)):  # only empty ones reach here
        return "{}" if isinstance(v, dict) else "[]"
    return json.dumps(str(v))  # a double-quoted YAML string


def _dump(v, indent: int) -> list[str]:
    pad = " " * indent
    nested = lambda x: isinstance(x, (dict, list)) and x  # noqa: E731
    lines = []
    if isinstance(v, dict):
        for k, x in v.items():
            key = json.dumps(str(k))
            if nested(x):
                lines += [f"{pad}{key}:", *_dump(x, indent + 2)]
            else:
                lines.append(f"{pad}{key}: {_scalar(x)}")
        return lines
    for x in v:  # a list
        if nested(x):
            sub = _dump(x, indent + 2)
            lines += [f"{pad}- {sub[0].lstrip()}", *sub[1:]]
        else:
            lines.append(f"{pad}- {_scalar(x)}")
    return lines


def dump_yaml(data: dict) -> str:
    """Block-style YAML of a container of dicts, lists and scalars."""
    return "\n".join(_dump(data, 0)) + "\n" if data else "{}\n"


def _load_yaml(path: str) -> dict:
    import yaml  # PyYAML: a host-side reader, not needed on the card

    with open(path) as f:
        return yaml.safe_load(f) or {}


class OmegaConf:
    """Shim with the OmegaConf classmethods the experiments use."""

    @staticmethod
    def load(path) -> Config:
        return Config(_load_yaml(path))

    @staticmethod
    def create(data=None) -> Config:
        return Config(data or {})

    @staticmethod
    def to_yaml(cfg: Config, resolve: bool = False) -> str:
        return cfg.to_yaml(resolve=resolve)

    @staticmethod
    def to_container(cfg: Config, resolve: bool = False):
        return cfg.to_container(resolve=resolve)

    @staticmethod
    def merge(*cfgs) -> Config:
        out = Config({})
        for c in cfgs:
            out.merge_with(c if isinstance(c, Config) else Config(c))
        return out


@contextlib.contextmanager
def open_dict(cfg: Config):
    """Kept for API parity: a Config is always writable."""
    yield cfg


# ---------------------------------------------------------------------------
# Hydra-style composition
# ---------------------------------------------------------------------------
def _compose_file(config_dir: str, rel_name: str, group_dir: str = "",
                  group_overrides: dict | None = None) -> Config:
    """Load ``<config_dir>/<group_dir>/<rel_name>.yaml`` and merge its
    defaults list in order (``_self_`` last unless listed); a defaults group
    named in ``group_overrides`` composes the replacement instead (consumed
    keys are popped)."""
    raw = _load_yaml(os.path.join(config_dir, group_dir, rel_name + ".yaml"))
    defaults = raw.pop("defaults", None)
    self_cfg = Config(raw)
    if not defaults:
        return self_cfg
    entries = list(defaults)
    if "_self_" not in [e if isinstance(e, str) else None for e in entries]:
        entries.append("_self_")
    out = Config({})
    for entry in entries:
        if entry == "_self_":
            out.merge_with(self_cfg)
        elif isinstance(entry, str):
            sub_group = "" if entry.startswith("/") else group_dir
            out.merge_with(_compose_file(config_dir, entry.lstrip("/"), sub_group))
        elif isinstance(entry, dict):
            for group, name in entry.items():
                if name is None:
                    continue
                grp = group.lstrip("/")
                if group_overrides and grp in group_overrides:
                    name = group_overrides.pop(grp)
                base = "" if group.startswith("/") else group_dir
                node = _compose_file(config_dir, str(name), os.path.join(base, grp))
                wrapper = Config({})
                target = wrapper
                keys = grp.split("/")
                for k in keys[:-1]:
                    target[k] = {}
                    target = target[k]
                target[keys[-1]] = node
                out.merge_with(wrapper)
        else:
            raise ValueError(f"Unsupported defaults entry: {entry!r}")
    return out


_FLOAT_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def _parse_override_value(v: str):
    import yaml  # PyYAML: a host-side reader, not needed on the card

    out = yaml.safe_load(v)
    # YAML 1.1 misses scientific notation without a dot ("1e-4"); hydra parses it
    if isinstance(out, str) and _FLOAT_RE.match(out) and any(c in out for c in ".eE"):
        return float(out)
    return out


def apply_overrides(cfg: Config, overrides: list[str]):
    """Dotted ``key=value`` overrides; ``+key=value`` adds, ``~key`` (or
    ``~key=value``, only when the value matches) deletes."""
    for ov in overrides:
        delete = ov.startswith("~")
        if "=" not in ov and not delete:
            raise ValueError(f"Override '{ov}' is not of the form key=value")
        key, _, val = ov.partition("=")
        key = key.lstrip("+~")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node:
                if delete:
                    raise ValueError(f"Could not delete '{key}': '{p}' is not in the config")
                node[p] = {}
            node = node[p]
        if delete:
            if parts[-1] not in node:
                raise ValueError(f"Could not delete '{key}': '{parts[-1]}' is not in the config")
            if "=" in ov:
                want, have = _parse_override_value(val), node[parts[-1]]
                if have != want:
                    raise ValueError(f"Could not delete '{key}={val}': current value "
                                     f"{have!r} does not match")
            del node[parts[-1]]
        else:
            node[parts[-1]] = _parse_override_value(val)
    return cfg


def compose(config_path: str = "configs", config_name: str = "default",
            overrides: list[str] | None = None) -> Config:
    """Compose a config the way ``@hydra.main`` does, with group overrides
    (``model=cfm/x`` swaps the defaults group when ``<config_path>/model/
    cfm/x.yaml`` exists) and value overrides."""
    config_dir = os.path.abspath(config_path)
    group_overrides, value_overrides = {}, []
    for ov in overrides or []:
        key, eq, val = ov.partition("=")
        group_yaml = os.path.join(config_dir, key, str(val) + ".yaml")
        if eq and "." not in key and "/" not in key and os.path.isfile(group_yaml):
            group_overrides[key] = str(val)
        else:
            value_overrides.append(ov)
    cfg = _compose_file(config_dir, config_name, group_overrides=group_overrides)
    # a group override with no matching defaults entry swaps the whole node
    for key, val in group_overrides.items():
        cfg[key] = _compose_file(config_dir, val, key)
    if "hydra" in cfg:
        del cfg["hydra"]
    if value_overrides:
        apply_overrides(cfg, value_overrides)
    return cfg


def compose_from_cli(argv: list[str], default_config_path="configs", default_config_name=None):
    """Parse hydra-style CLI args: -cp/--config-path, -cn/--config-name, overrides."""
    config_path, config_name = default_config_path, default_config_name
    overrides = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-cp", "--config-path"):
            config_path = argv[i + 1]
            i += 2
        elif a in ("-cn", "--config-name"):
            config_name = argv[i + 1]
            i += 2
        elif a.startswith("--config-path="):
            config_path = a.split("=", 1)[1]
            i += 1
        elif a.startswith("--config-name="):
            config_name = a.split("=", 1)[1]
            i += 1
        else:
            overrides.append(a)
            i += 1
    if config_name is None:
        raise ValueError("No config name given (use -cn <name>)")
    if config_name.endswith(".yaml"):
        config_name = config_name[: -len(".yaml")]
    return compose(config_path, config_name, overrides)


# ---------------------------------------------------------------------------
# instantiate()
# ---------------------------------------------------------------------------
def _locate(target: str):
    target = TARGET_REMAP.get(target, target)
    if target.startswith("vit4hep_tpu."):
        raise NotImplementedError(f"{target} is not ported to vit4hep_tpu_torch yet "
                                  "(ROADMAP.md, queue 1)")
    module_name, _, attr = target.rpartition(".")
    return getattr(importlib.import_module(module_name), attr)


def _build(v):
    """One instantiate() argument: nested targets become objects, Config
    nodes plain resolved dicts, lists recurse elementwise."""
    if isinstance(v, Config):
        return instantiate(v) if "_target_" in v else {k: _build(v[k]) for k in v}
    if isinstance(v, dict):
        return instantiate(v) if "_target_" in v else {k: _build(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_build(x) for x in v]
    return v


def instantiate(cfg, **kwargs):
    """Build the object a config node with a ``_target_`` names (a
    :class:`Config` or a plain dict); interpolations are resolved, ``???``
    raises, and nested ``_target_`` nodes at any depth are built first."""
    data = {k: cfg[k] for k in cfg} if isinstance(cfg, Config) else dict(cfg)
    if "_target_" not in data:
        return {k: _build(v) for k, v in data.items()}
    target = data.pop("_target_")
    call_kwargs = {k: _build(v) for k, v in data.items()}
    call_kwargs.update(kwargs)
    return _locate(str(target))(**call_kwargs)

"""Nets' weights from the reference's own torch checkpoints (port of the
ViT and energy-net parts of ``vit4hep_tpu/utils/torch_migration.py``).

The reference saves ``torch.save({"model": state_dict, "optimizer",
"scheduler", "ema"})``; its model keys are ``net.<param>``, with
``module.`` prefixes from DDP. The port's nets already carry the
reference's parameter names, so migrating is key handling:

- the prefixes are stripped (:func:`strip_state_dict_prefixes`);
- the reference's buffers (``pos_z``/``pos_y``/``pos_x``, ``pos_embed``,
  ``attn_mask``; ``grid`` is a ViT1D's), functions of the config, are held
  against the ones the port computes from the same config and dropped;
  one that disagrees, or that the port's net has no counterpart of,
  raises;
- a fine-tuned reference ViT wraps its embedders in Sequentials
  (``x_embedder.0`` the mapper, ``x_embedder.2`` the backbone's;
  ``c_embedder.0`` and ``c_embedder.2.{0,2}``): they become ``x_mapper`` /
  ``c_mapper`` and the plain embedders;
- the energy net's frozen Fourier weights ``time_embed.0.W`` become the
  config's ``fourier_w`` (the port derives them from the config and does
  not store them), and the ``layer.*`` alias of ``layers.0`` is dropped
  once it is seen to equal it.

Whatever is left must load into the net with ``strict=True``. The cINN and
EMA converters of the JAX module are not ported (ROADMAP.md, queue 1 item
10). A port checkpoint (``utils/checkpoint``, with its ``step``) loads as
it is: :func:`load_net_state_dict` reads either.
"""

from __future__ import annotations

import numpy as np
import torch

from vit4hep_tpu_torch.ops import pos_embed as pe_ops

BUFFER_KEYS = ("pos_z", "pos_y", "pos_x", "grid", "pos_embed", "attn_mask")


def strip_state_dict_prefixes(sd, prefixes=("module.", "net.")):
    """``sd`` with the wrapper prefixes stripped from every key, stacked in
    any order (a DDP-saved model gives ``net.module.<param>``)."""
    out = {}
    for k, v in sd.items():
        stripped = True
        while stripped:
            stripped = False
            for p in prefixes:
                if k.startswith(p):
                    k, stripped = k[len(p):], True
        out[k] = v
    return out


def is_reference_checkpoint(payload) -> bool:
    """A reference checkpoint has a ``model`` section and none of the port's
    counters."""
    return isinstance(payload, dict) and "model" in payload and "step" not in payload


def load_torch_checkpoint(path, section="model"):
    """The prefix-stripped state dict of ``section`` of a reference
    ``model_run<i>.pt``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    sd = payload[section] if isinstance(payload, dict) and section in payload else payload
    if not isinstance(sd, dict):
        raise ValueError(f"Section '{section}' of {path} is not a state dict")
    return strip_state_dict_prefixes(sd)


def net_kind_from_target(target: str) -> str:
    """``energy`` or ``vit`` for a ``net._target_`` (the shared configs', the
    port's or the reference's path). A ViT1D is a cINN's subnet, whose
    converter is not ported."""
    if "transformer_cfm" in target or "ParallelTransformer" in target \
            or "MLPTransformer" in target:
        return "energy"
    if target.rsplit(".", 1)[-1] in ("ViT", "ViT2"):
        return "vit"
    raise ValueError(f"No torch-checkpoint converter for net target '{target}' "
                     "(supported: ViT, ParallelTransformer)")


def expected_buffers(param: dict) -> dict[str, np.ndarray]:
    """The buffers a reference ViT of this ``net.param`` registers, as the
    port computes them from the config."""
    from vit4hep_tpu_torch.models.vit import ViTParams

    p = ViTParams.create(param)
    out = {}
    if p.learn_pos_embed:
        out.update(zip(("pos_z", "pos_y", "pos_x"), pe_ops.create_meshgrid(p.num_patches)))
    else:
        out["pos_embed"] = pe_ops.get_sincos_pos_embed(
            p.pos_embedding_coords, p.num_patches[0], p.hidden_dim, p.dim, p.temperature)
    if p.causal_attn and p.dim == 3:
        out["attn_mask"] = pe_ops.layer_causal_mask(p.num_patches[0])
    return out


def _check_buffer(key, ref, want):
    ref = ref.detach().cpu()
    if want is None:
        raise ValueError(f"reference buffer {key} has no counterpart in the port's net of this "
                         "config")
    if ref.numel() != want.size:
        raise ValueError(f"reference buffer {key} has {ref.numel()} entries, the port's "
                         f"{want.size}")
    if want.dtype == bool:
        same = np.array_equal(ref.reshape(-1).numpy() != 0, want.reshape(-1))
    else:
        same = np.allclose(ref.reshape(-1).double().numpy(), want.reshape(-1), rtol=0,
                           atol=1e-6)
    if not same:
        raise ValueError(f"reference buffer {key} differs from the one the port computes from "
                         "the config")


def _renamed(sd, old, new):
    return {new + k[len(old):] if k.startswith(old) else k: v for k, v in sd.items()}


def convert_vit_state_dict(sd, param: dict) -> dict:
    """A prefix-stripped reference ViT state dict -> the port's net state
    dict for ``net.param`` (buffers checked and dropped, fine-tuned
    embedders renamed)."""
    sd = dict(sd)
    want = expected_buffers(param)
    for k in [k for k in sd if k.split(".")[-1] in BUFFER_KEYS]:
        _check_buffer(k, sd.pop(k), want.get(k.split(".")[-1]))
    # a fine-tuned net: Sequential(mapper, SiLU, the backbone's embedder)
    if "x_embedder.0.weight" in sd:
        sd = _renamed(_renamed(sd, "x_embedder.0.", "x_mapper."), "x_embedder.2.", "x_embedder.")
    if "c_embedder.2.0.weight" in sd:
        sd = _renamed(_renamed(sd, "c_embedder.0.", "c_mapper."), "c_embedder.2.", "c_embedder.")
    return sd


def convert_energy_state_dict(sd) -> tuple[dict, dict]:
    """A prefix-stripped reference ``ParallelTransformer`` state dict ->
    (the port's net state dict, ``{"fourier_w": [...]}`` to merge into the
    net's ``param`` before it is built)."""
    sd = dict(sd)
    patch = {"fourier_w": sd.pop("time_embed.0.W").detach().cpu().float().reshape(-1).tolist()}
    for k in [k for k in sd if k.startswith("layer.")]:
        alias = "layers.0." + k[len("layer."):]
        if alias not in sd or not torch.equal(sd[k], sd[alias]):
            raise ValueError(f"reference entry {k} is not the alias of {alias}")
        del sd[k]
    return sd, patch


def convert_net_checkpoint(model_cfg, payload):
    """The net state dict of a reference checkpoint's payload for the model
    of ``model_cfg`` (an energy net's ``fourier_w`` is written into
    ``model_cfg.net.param``: call it before building the model), or None for
    a port checkpoint."""
    if not is_reference_checkpoint(payload):
        return None
    sd = strip_state_dict_prefixes(payload["model"])
    if net_kind_from_target(str(model_cfg.net._target_)) == "energy":
        sd, patch = convert_energy_state_dict(sd)
        for k, v in patch.items():
            model_cfg.net.param[k] = v
        return sd
    param = model_cfg.net.param
    param = param.to_container(resolve=True) if hasattr(param, "to_container") else dict(param)
    return convert_vit_state_dict(sd, param)


def load_net_state_dict(model_cfg, path) -> tuple[dict, bool]:
    """(the state dict of the model's net, whether it was migrated) from a
    ``model_run<i>.pt``: the reference's, converted, or the port's own."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    converted = convert_net_checkpoint(model_cfg, payload)
    if converted is not None:
        return converted, True
    model = payload["model"]
    stray = [k for k in model if not k.startswith("net.")]
    if stray:
        raise ValueError(f"{path}: entries outside the net: {stray[:5]}")
    return {k[len("net."):]: v for k, v in model.items()}, False

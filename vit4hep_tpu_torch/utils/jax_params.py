"""JAX -> port weight conversion.

Turns a Flax param tree (nested dicts of arrays; numpy or anything
``np.asarray`` accepts) into the ``state_dict`` of the port's ``ViTNet``,
``ParallelTransformerNet``, cINN flow (``CaloChallengeCINN``,
``CaloChallengeEnergyCINN``), or the evaluation's
``DNN`` / ``ResNet3D`` classifiers. The name map is
``convert_vit_state_dict`` / ``convert_energy_state_dict`` of
``vit4hep_tpu/utils/torch_migration.py`` run in reverse: a Dense ``kernel (in, out)`` becomes a Linear ``weight
(out, in)``, a LayerNorm ``scale``/``bias`` becomes ``weight``/``bias``, an
``nn.Embed`` table becomes an ``nn.Embedding`` weight, and the energy
transformer's q/k/v Dense triples are packed into ``in_proj_weight`` rows.
Unmapped entries raise, so no weight is dropped silently.

A ``CaloChallengeCFM_DS1``'s net is a ViT whose positional grid spans the
sections: its params take :func:`convert_vit_params` as any ViT's (the grid
is not a parameter), and its energy model's :func:`convert_energy_params`.
A ViT with ``learn_pos_embed: false`` has no ``pos_embed_freqs``; a
fine-tuned ViT's ``x_mapper`` / ``c_mapper`` carry over as Linears.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


class _Converter:
    def __init__(self, variables):
        self.params = variables.get("params", variables)
        self.sd: dict[str, torch.Tensor] = {}
        self.used: set[str] = set()

    def node(self, *path):
        self.used.add(path[0])
        n = self.params
        for p in path:
            n = n[p]
        return n

    def dense(self, key, *path):
        n = self.node(*path)
        self.sd[f"{key}.weight"] = _t(n["kernel"]).T.contiguous()
        self.sd[f"{key}.bias"] = _t(n["bias"])

    def layer_norm(self, key, *path):
        n = self.node(*path)
        self.sd[f"{key}.weight"] = _t(n["scale"])
        self.sd[f"{key}.bias"] = _t(n["bias"])

    def finish(self):
        leftover = set(self.params) - self.used
        if leftover:
            raise ValueError("JAX parameters with no port counterpart: "
                             + ", ".join(sorted(leftover)))
        return self.sd


def convert_vit_params(variables) -> dict[str, torch.Tensor]:
    """Flax ``ViTNet`` (or ``ViT1DNet``, which has no time embedder) params
    -> the port's ``ViTNet`` (``ViT1DNet``) state dict."""
    c = _Converter(variables)
    if "t_embedder" in c.params:
        c.dense("t_embedder.mlp.0", "t_embedder", "Dense_0")
        c.dense("t_embedder.mlp.2", "t_embedder", "Dense_1")
    for mapper in ("x_mapper", "c_mapper"):  # a fine-tuned ViT's mapper layers
        if mapper in c.params:
            c.dense(mapper, mapper)
    c.dense("x_embedder", "x_embedder")
    c.dense("c_embedder.0", "c_embedder", "Dense_0")
    c.dense("c_embedder.2", "c_embedder", "Dense_1")
    if "pos_embed_freqs" in c.params:
        c.sd["pos_embed_freqs"] = _t(c.node("pos_embed_freqs"))
    i = 0
    while f"block_{i}" in c.params:
        b, k = f"block_{i}", f"blocks.{i}"
        c.dense(f"{k}.adaLN_modulation.1", b, "adaLN_modulation")
        c.dense(f"{k}.attn.qkv", b, "Attention_0", "Dense_0")
        c.dense(f"{k}.attn.proj", b, "Attention_0", "Dense_1")
        c.dense(f"{k}.mlp.fc1", b, "MlpBlock_0", "Dense_0")
        c.dense(f"{k}.mlp.fc2", b, "MlpBlock_0", "Dense_1")
        i += 1
    c.dense("final_layer.adaLN_modulation.1", "final_layer", "adaLN_modulation")
    c.dense("final_layer.linear", "final_layer", "Dense_0")
    return c.finish()


def convert_mlp_params(variables) -> dict[str, torch.Tensor]:
    """Flax ``SubnetMLP`` params (``Dense_0`` .. ``Dense_n``) -> the port's
    ``SubnetMLP`` state dict (``layers.<i>``)."""
    c = _Converter(variables)
    i = 0
    while f"Dense_{i}" in c.params:
        c.dense(f"layers.{i}", f"Dense_{i}")
        i += 1
    return c.finish()


# a block's own arrays: AllInOneBlock's ActNorm, ElementwiseRQSBlock's free spline
_BLOCK_ARRAYS = ("global_scale", "global_offset", "spline_parameters")


def convert_cinn_params(variables) -> dict[str, torch.Tensor]:
    """Flax ``FlowChain`` params of a cINN (coupling blocks ``blocks_<j>``;
    the permutations have none) -> the state dict of the port's flow
    (``model.net``). A block's subnets (``subnet1``, ``subnet2``, or
    ``subnet``) are ViT1Ds or ``SubnetMLP``s; its own arrays
    (``global_scale``, ``global_offset``, ``spline_parameters``) keep their
    names."""
    c = _Converter(variables)
    for block in [k for k in c.params if k.startswith("blocks_")]:
        j = block[len("blocks_"):]
        for name, node in c.node(block).items():
            key = f"blocks.{j}.{name}"
            if name in _BLOCK_ARRAYS:
                c.sd[key] = _t(node)
                continue
            sd = (convert_vit_params if "x_embedder" in node else convert_mlp_params)(node)
            c.sd.update({f"{key}.{k}": v for k, v in sd.items()})
    return c.finish()


def _mha(c, key, *path):
    """A Flax ``_MHA``'s q/k/v Denses packed into ``in_proj_weight`` rows,
    and its ``out_proj``."""
    n = c.node(*path)
    c.sd[f"{key}.in_proj_weight"] = torch.cat(
        [_t(n[p]["kernel"]).T for p in ("q_proj", "k_proj", "v_proj")]).contiguous()
    c.sd[f"{key}.in_proj_bias"] = torch.cat(
        [_t(n[p]["bias"]) for p in ("q_proj", "k_proj", "v_proj")])
    c.dense(f"{key}.out_proj", *path, "out_proj")


def _transformer_layer(c, key, side, src):
    """A Flax ``_EncoderLayer`` / ``_DecoderLayer`` -> the port's layer."""
    _mha(c, f"{key}.self_attn", src, "self_attn")
    if side == "decoder":
        _mha(c, f"{key}.multihead_attn", src, "cross_attn")
    c.dense(f"{key}.linear1", src, "_FeedForward_0", "Dense_0")
    c.dense(f"{key}.linear2", src, "_FeedForward_0", "Dense_1")
    for j in range(3 if side == "decoder" else 2):
        c.layer_norm(f"{key}.norm{j + 1}", src, f"LayerNorm_{j}")


def convert_energy_params(variables) -> dict[str, torch.Tensor]:
    """Flax ``ParallelTransformerNet`` params -> the port's state dict."""
    c = _Converter(variables)
    c.dense("time_embed.1", "time_embed")
    for ours, theirs in (("x_embed", "x_embed"), ("c_embed", "c_embed"),
                         ("head_0", "layers.0"), ("head_1", "layers.2")):
        if ours in c.params:
            c.dense(theirs, ours)
    for name in ("pos_embed_x", "pos_embed_c"):
        if name in c.params:
            c.sd[f"{name}.weight"] = _t(c.node(name, "embedding"))
    for side in ("encoder", "decoder"):
        i = 0
        while f"{side}_{i}" in c.params:
            _transformer_layer(c, f"transformer.{side}.layers.{i}", side, f"{side}_{i}")
            i += 1
        if f"{side}_norm" in c.params:
            c.layer_norm(f"transformer.{side}.norm", f"{side}_norm")
    return c.finish()


def convert_ar_transformer_params(variables) -> dict[str, torch.Tensor]:
    """Flax ``ARTransformerNet`` params -> the port's ``ARTransformerNet``
    state dict: ``encoder_i`` / ``decoder_i`` -> ``encoders.i`` /
    ``decoders.i``, the subnet's ``Dense_k`` -> ``subnet.{2k}`` (its
    activations between), ``x_embed_k`` / ``c_embed_k`` -> ``x_embed.k`` /
    ``c_embed.k``."""
    c = _Converter(variables)
    c.dense("time_embed", "time_embed")
    for side in ("encoder", "decoder"):
        i = 0
        while f"{side}_{i}" in c.params:
            _transformer_layer(c, f"{side}s.{i}", side, f"{side}_{i}")
            i += 1
        c.layer_norm(f"{side}_norm", f"{side}_norm")
    k = 0
    while f"Dense_{k}" in c.params.get("subnet", {}):
        c.dense(f"subnet.{2 * k}", "subnet", f"Dense_{k}")
        k += 1
    for name in ("x_embed", "c_embed"):
        for j in range(2):
            if f"{name}_{j}" in c.params:
                c.dense(f"{name}.{j}", f"{name}_{j}")
    return c.finish()


def convert_classifier_params(variables) -> dict[str, torch.Tensor]:
    """Flax ``DNN`` or ``ResNet3D`` variables (``params`` and, for the
    ResNet, ``batch_stats``) -> the state dict of the port's
    ``evaluation/classifiers`` network. A Conv ``kernel`` (D, H, W, in, out)
    becomes a Conv3d ``weight`` (out, in, D, H, W); a BatchNorm's ``scale``,
    ``bias``, ``mean`` and ``var`` become ``weight``, ``bias``,
    ``running_mean`` and ``running_var``."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    used: set[str] = set()

    def dense(key, node):
        sd[f"{key}.weight"] = _t(node["kernel"]).T.contiguous()
        sd[f"{key}.bias"] = _t(node["bias"])

    def conv(key, node):
        sd[f"{key}.weight"] = _t(node["kernel"]).permute(4, 3, 0, 1, 2).contiguous()

    def norm(key, node, stat):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _t(node["scale"]), _t(node["bias"])
        sd[f"{key}.running_mean"], sd[f"{key}.running_var"] = _t(stat["mean"]), _t(stat["var"])

    if "stem" not in params:  # DNN: Dense_0 .. Dense_{L}, the last one the output
        n = len(params)
        for i in range(n):
            dense("out" if i == n - 1 else f"hidden.{i}", params[f"Dense_{i}"])
            used.add(f"Dense_{i}")
    else:
        norm("e_norm", params["e_norm"], stats["e_norm"])
        conv("stem", params["stem"])
        norm("bn", params["BatchNorm_0"], stats["BatchNorm_0"])
        dense("fc", params["Dense_0"])
        used |= {"e_norm", "stem", "BatchNorm_0", "Dense_0"}
        kind = "BasicBlock3D" if "BasicBlock3D_0" in params else "Bottleneck3D"
        n_conv = 2 if kind == "BasicBlock3D" else 3
        k = 0
        while f"{kind}_{k}" in params:
            name = f"{kind}_{k}"
            p, s = params[name], stats[name]
            for j in range(n_conv):
                conv(f"blocks.{k}.conv{j + 1}", p[f"Conv_{j}"])
                norm(f"blocks.{k}.bn{j + 1}", p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"])
            if f"Conv_{n_conv}" in p:
                conv(f"blocks.{k}.shortcut.0", p[f"Conv_{n_conv}"])
                norm(f"blocks.{k}.shortcut.1", p[f"BatchNorm_{n_conv}"], s[f"BatchNorm_{n_conv}"])
            used.add(name)
            k += 1
    leftover = set(params) - used
    if leftover:
        raise ValueError("JAX parameters with no port counterpart: " + ", ".join(sorted(leftover)))
    return sd

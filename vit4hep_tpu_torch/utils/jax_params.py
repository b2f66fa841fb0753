"""JAX -> port weight conversion.

Turns a Flax param tree (nested dicts of arrays; numpy or anything
``np.asarray`` accepts) into the ``state_dict`` of the port's ``ViTNet``,
``ParallelTransformerNet`` or ``CaloChallengeCINN`` flow. The name map is
``convert_vit_state_dict`` / ``convert_energy_state_dict`` of
``vit4hep_tpu/utils/torch_migration.py`` run in reverse: a Dense ``kernel (in, out)`` becomes a Linear ``weight
(out, in)``, a LayerNorm ``scale``/``bias`` becomes ``weight``/``bias``, an
``nn.Embed`` table becomes an ``nn.Embedding`` weight, and the energy
transformer's q/k/v Dense triples are packed into ``in_proj_weight`` rows.
Unmapped entries raise, so no weight is dropped silently.
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


def convert_cinn_params(variables) -> dict[str, torch.Tensor]:
    """Flax ``FlowChain`` params of a ``CaloChallengeCINN`` (coupling block
    ``blocks_<j>`` with ViT1D subnets ``subnet1``/``subnet2``; the
    permutations have none) -> the state dict of the port's flow
    (``model.net``)."""
    c = _Converter(variables)
    for block in [k for k in c.params if k.startswith("blocks_")]:
        j = block[len("blocks_"):]
        for sub in ("subnet1", "subnet2"):
            sd = convert_vit_params(c.node(block, sub))
            c.sd.update({f"blocks.{j}.{sub}.{k}": v for k, v in sd.items()})
    return c.finish()


def convert_energy_params(variables) -> dict[str, torch.Tensor]:
    """Flax ``ParallelTransformerNet`` params -> the port's state dict."""
    c = _Converter(variables)

    def mha(key, *path):
        n = c.node(*path)
        c.sd[f"{key}.in_proj_weight"] = torch.cat(
            [_t(n[p]["kernel"]).T for p in ("q_proj", "k_proj", "v_proj")]).contiguous()
        c.sd[f"{key}.in_proj_bias"] = torch.cat(
            [_t(n[p]["bias"]) for p in ("q_proj", "k_proj", "v_proj")])
        c.dense(f"{key}.out_proj", *path, "out_proj")

    c.dense("time_embed.1", "time_embed")
    for ours, theirs in (("x_embed", "x_embed"), ("c_embed", "c_embed"),
                         ("head_0", "layers.0"), ("head_1", "layers.2")):
        if ours in c.params:
            c.dense(theirs, ours)
    for name in ("pos_embed_x", "pos_embed_c"):
        if name in c.params:
            c.sd[f"{name}.weight"] = _t(c.node(name, "embedding"))
    for side, n_norms in (("encoder", 2), ("decoder", 3)):
        i = 0
        while f"{side}_{i}" in c.params:
            src, t = f"{side}_{i}", f"transformer.{side}.layers.{i}"
            mha(f"{t}.self_attn", src, "self_attn")
            if side == "decoder":
                mha(f"{t}.multihead_attn", src, "cross_attn")
            c.dense(f"{t}.linear1", src, "_FeedForward_0", "Dense_0")
            c.dense(f"{t}.linear2", src, "_FeedForward_0", "Dense_1")
            for j in range(n_norms):
                c.layer_norm(f"{t}.norm{j + 1}", src, f"LayerNorm_{j}")
            i += 1
        if f"{side}_norm" in c.params:
            c.layer_norm(f"transformer.{side}.norm", f"{side}_norm")
    return c.finish()

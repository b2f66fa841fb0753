"""Cross-dataset fine-tuning experiments (port of
``vit4hep_tpu/experiments/calochallenge_finetuning.py``).

:class:`FTMixin` swaps the target config's net for the backbone run's
architecture with the target's geometry (``models/finetuning.
build_ft_vit_params``), copies the backbone's weights in with the embedder
surgery (``transfer_backbone_params``) unless the run warm-starts, and
trains with the three-group optimizer (backbone, head, embedder; each at
its own lr and schedule). The backbone run is read through
:meth:`FTMixin.backbone_run_config` (its ``config_<idx>.yaml``, which names
its run dir and index) and its ``models/model_run<idx>.pt``: the port's
checkpoint or the reference's, migrated (``utils/torch_migration``).
``use_ema`` follows the backbone's config first. On a grid with a model
axis the state is split after the surgery, as JAX shards it there
(``:95-97``): the base experiment's ``_init_optimizer`` splits whatever
the model holds once the transfer is done.

:class:`CaloChallengeFT_fromLEM` samples behind a LEMURS backbone: the
shape model's condition is ``[u | E | theta, phi, label]``, the energy
model sees E alone, and without ``sample_us`` the test set's conditions
(whose pipeline's ``AddLEMURSConditions`` appended the same columns) are
used.
"""

from __future__ import annotations

import os

import numpy as np

from vit4hep_tpu_torch.experiments.calochallenge import CaloChallenge
from vit4hep_tpu_torch.models import finetuning as ft
from vit4hep_tpu_torch.models.vit import ViTNet
from vit4hep_tpu_torch.utils.config import OmegaConf, instantiate
from vit4hep_tpu_torch.utils.logger import LOGGER
from vit4hep_tpu_torch.utils.misc import count_parameters
from vit4hep_tpu_torch.utils.torch_migration import load_net_state_dict


class FTMixin:
    """The fine-tuning lifecycle, mixed into a family's experiment."""

    def __init__(self, cfg, rank=0, world_size=1, device="cuda"):
        super().__init__(cfg, rank, world_size, device)
        # the target geometry, before the net is swapped for the backbone's
        param = self.cfg.model.net.param.to_container(resolve=True)
        self.target_param = dict(num_patches=param["num_patches"],
                                 patch_dim=int(param["patch_dim"]),
                                 condition_dim=int(param["condition_dim"]))

    def backbone_run_config(self):
        """The backbone run's composed config, read from
        ``finetuning.backbone_cfg``."""
        return OmegaConf.load(str(self.cfg.finetuning.backbone_cfg))

    def init_model(self):
        self.backbone_cfg = self.backbone_run_config()
        backbone_param = self.backbone_cfg.model.net.param.to_container(resolve=True)
        net_cfg = ft.build_ft_vit_params(backbone_param, self.target_param, self.cfg.finetuning)
        model_cfg = self.cfg.model.to_container(resolve=True)
        del model_cfg["net"]
        self.model = instantiate(model_cfg, net=ViTNet(net_cfg))
        if not self.warm_start:
            path = os.path.join(str(self.backbone_cfg.run_dir), "models",
                                f"model_run{self.backbone_cfg.run_idx}.pt")
            LOGGER.info(f"Loading pretrained model from {path}")
            backbone_sd, migrated = load_net_state_dict(self.backbone_cfg.model, path)
            if migrated:
                LOGGER.info("Backbone is a reference torch checkpoint: migrated")
            net = self.model.net
            net.load_state_dict(ft.transfer_backbone_params(net.state_dict(), backbone_sd,
                                                            self.cfg.finetuning))
        self.model.to(self.device)
        self.use_ema = bool(self.backbone_cfg.get("ema", self.cfg.get("ema", False)))
        num_parameters = count_parameters(self.model)
        self._log("num_parameters", float(num_parameters))
        LOGGER.info(f"Instantiated fine-tune model with {num_parameters} parameters")

    def param_groups(self):
        return ft.ft_param_groups(self.model.net, self.cfg.training, self.cfg.finetuning)

    def with_lemurs_conditions(self, cond):
        """``cond`` (N, k) with a LEMURS backbone's fixed (``gen_theta``,
        ``gen_phi``, ``gen_label``) columns after it."""
        extra = np.asarray([float(self.cfg.gen_theta), float(self.cfg.gen_phi)]
                           + [float(v) for v in self.cfg.gen_label], np.float32)
        return np.concatenate([cond, np.tile(extra, (len(cond), 1))], axis=1)


class CaloChallengeFTCFM(FTMixin, CaloChallenge):
    """Fine-tune a pretrained shape CFM on another CaloChallenge dataset."""


class CaloChallengeFT_fromLEM(CaloChallengeFTCFM):
    """Fine-tuning from a LEMURS backbone: (theta, phi, label) follow E in
    the sampling conditions."""

    energy_cond_width = 1

    def sampling_conditions(self, e_inc):
        return self.with_lemurs_conditions(super().sampling_conditions(e_inc))

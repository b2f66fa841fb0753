"""Launcher of the port: compose the config, dispatch on ``exp_type``, run.

    python -m vit4hep_tpu_torch.experiments.main -cn calochallenge/cfm/calochallenge_ds2 \\
        exp_name=my_exp data_dir=/data/calo_challenge
    python -m vit4hep_tpu_torch.experiments.main -cp runs/MyExp/<run> -cn config \\
        warm_start_idx=0

The CLI is the root ``main.py``'s (``-cp``/``-cn`` and dotted overrides),
plus ``device=cpu`` to run on the CPU (default: the CUDA device). Composing
the YAML tree needs PyYAML and the data files need h5py, so the launcher
runs on a host that has both. Every ``exp_type`` of the root launcher is
ported: calochallenge, calogan, lemurs, calohadronic and the fine-tuning
types calochallenge_ft_cfm, calochallenge_ft_lem_cfm, calogan_ft_cfm and
calohadronic_ft.

    python -m vit4hep_tpu_torch.experiments.main \\
        -cn calochallenge/finetuning/calochallenge_ds2tods3_ft \\
        finetuning.backbone_cfg=runs/CaloChallenge/<ds2 run>/config_0.yaml data_dir=...
"""

from __future__ import annotations

import importlib
import sys

from vit4hep_tpu_torch.utils.config import compose_from_cli
from vit4hep_tpu_torch.utils.logger import LOGGER

# exp_type -> (module under vit4hep_tpu_torch.experiments, class), as the root launcher
_EXPERIMENTS = {
    "calochallenge": ("calochallenge", "CaloChallenge"),
    "calochallenge_ft_cfm": ("calochallenge_finetuning", "CaloChallengeFTCFM"),
    "calochallenge_ft_lem_cfm": ("calochallenge_finetuning", "CaloChallengeFT_fromLEM"),
    "calogan": ("calogan", "CaloGAN"),
    "calogan_ft_cfm": ("calogan_finetuning", "CaloGANFTCFM"),
    "lemurs": ("lemurs", "LEMURS"),
    "calohadronic": ("calohadronic", "CaloHadronic"),
    "calohadronic_ft": ("calohadronic_finetuning", "CaloHadronicFT"),
}


def get_experiment(exp_type: str):
    if exp_type not in _EXPERIMENTS:
        raise ValueError(f"exp_type {exp_type} not implemented")
    module, name = _EXPERIMENTS[exp_type]
    return getattr(importlib.import_module(f"vit4hep_tpu_torch.experiments.{module}"), name)


def main(argv=None, device="cuda"):
    """Run one experiment; ``device=<name>`` among the overrides wins over
    the ``device`` argument."""
    argv = list(sys.argv[1:] if argv is None else argv)
    for a in [a for a in argv if a.startswith("device=")]:
        device = a.split("=", 1)[1]
        argv.remove(a)
    cfg = compose_from_cli(argv)
    if cfg.get("use_float64", False) or cfg.get("distributed", False):
        raise NotImplementedError("use_float64 and distributed runs are not ported yet "
                                  "(ROADMAP.md queue 1)")
    experiment = get_experiment(cfg.exp_type)(cfg, device=device)
    experiment()
    LOGGER.info("Run finished")
    return experiment


if __name__ == "__main__":
    main()

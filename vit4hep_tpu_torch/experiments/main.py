"""Launcher of the port: compose the config, dispatch on ``exp_type``, run.

    python -m vit4hep_tpu_torch.experiments.main -cn calochallenge/cfm/calochallenge_ds2 \\
        exp_name=my_exp data_dir=/data/calo_challenge
    python -m vit4hep_tpu_torch.experiments.main -cp runs/MyExp/<run> -cn config \\
        warm_start_idx=0

The CLI is the root ``main.py``'s (``-cp``/``-cn`` and dotted overrides),
plus ``device=cpu`` to run on the CPU (default: the CUDA device). Composing
the YAML tree needs PyYAML and the data files need h5py, so the launcher
runs on a host that has both. ``exp_type`` calochallenge, calogan, lemurs
and calohadronic are ported; the fine-tuning types raise.
"""

from __future__ import annotations

import sys

from vit4hep_tpu_torch.utils.config import compose_from_cli
from vit4hep_tpu_torch.utils.logger import LOGGER

_EXP_TYPES = ("calochallenge", "calochallenge_ft_cfm", "calochallenge_ft_lem_cfm", "calogan",
              "calogan_ft_cfm", "lemurs", "calohadronic", "calohadronic_ft")


def get_experiment(exp_type: str):
    if exp_type == "calochallenge":
        from vit4hep_tpu_torch.experiments.calochallenge import CaloChallenge

        return CaloChallenge
    if exp_type == "calogan":
        from vit4hep_tpu_torch.experiments.calogan import CaloGAN

        return CaloGAN
    if exp_type == "lemurs":
        from vit4hep_tpu_torch.experiments.lemurs import LEMURS

        return LEMURS
    if exp_type == "calohadronic":
        from vit4hep_tpu_torch.experiments.calohadronic import CaloHadronic

        return CaloHadronic
    if exp_type in _EXP_TYPES:
        raise NotImplementedError(f"exp_type {exp_type} (fine-tuning) is not ported yet "
                                  "(ROADMAP.md queue 1 item 8)")
    raise ValueError(f"exp_type {exp_type} not implemented")


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

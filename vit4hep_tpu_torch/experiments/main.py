"""Launcher of the port: compose the config, dispatch on ``exp_type``, run.

    python -m vit4hep_tpu_torch.experiments.main -cn calochallenge/cfm/calochallenge_ds2 \\
        exp_name=my_exp data_dir=/data/calo_challenge
    python -m vit4hep_tpu_torch.experiments.main -cp runs/MyExp/<run> -cn config \\
        warm_start_idx=0

The CLI is the root ``main.py``'s (``-cp``/``-cn`` and dotted overrides),
plus ``device=cpu`` to run on the CPU (default: the CUDA device) and
``backend=nccl|gloo`` for a distributed run. ``distributed=true`` joins a
process group from the torchrun variables (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``; JAX
``main.py:79-103``), one process per device, NCCL on CUDA devices and gloo
on the CPU unless ``backend=`` says otherwise (two ranks that share one
card need ``backend=gloo``: NCCL refuses them), and lays the ranks out on a
(data, model) grid of ``model_parallel`` columns (``parallel/mesh.py``):

    torchrun --nproc-per-node 4 -m vit4hep_tpu_torch.experiments.main \
        -cn calochallenge/cfm/calochallenge_ds2 distributed=true model_parallel=2 ...

Composing the YAML tree needs PyYAML and the data files need h5py, so the
launcher runs on a host that has both. Every ``exp_type`` of the root
launcher is ported: calochallenge, calogan, lemurs, calohadronic and the
fine-tuning types calochallenge_ft_cfm, calochallenge_ft_lem_cfm,
calogan_ft_cfm and calohadronic_ft.

    python -m vit4hep_tpu_torch.experiments.main \\
        -cn calochallenge/finetuning/calochallenge_ds2tods3_ft \\
        finetuning.backbone_cfg=runs/CaloChallenge/<ds2 run>/config_0.yaml data_dir=...
"""

from __future__ import annotations

import importlib
import sys

import torch.distributed as dist

from vit4hep_tpu_torch.parallel.mesh import init_distributed
from vit4hep_tpu_torch.utils.config import apply_overrides, compose_from_cli
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


def _take(argv, key, default):
    """The value of the last ``key=...`` of ``argv`` (else ``default``),
    every such entry removed from ``argv``."""
    for a in [a for a in argv if a.startswith(f"{key}=")]:
        default = a.split("=", 1)[1]
        argv.remove(a)
    return default


def main(argv=None, device="cuda", cfg=None, experiment_cls=None):
    """Run one experiment; ``device=<name>`` among the overrides wins over
    the ``device`` argument, and ``backend=<name>`` picks a distributed
    run's backend. A caller with a composed ``cfg`` (a host without PyYAML)
    passes it instead of ``-cn``, and may pass the experiment class."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = _take(argv, "device", device)
    backend = _take(argv, "backend", None)
    cfg = compose_from_cli(argv) if cfg is None else apply_overrides(cfg, argv)
    if cfg.get("use_float64", False):
        raise NotImplementedError("use_float64 is not ported yet (ROADMAP.md queue 1, the "
                                  "dtypes)")
    rank, world_size = 0, 1
    # a process group the caller made outlives the run; one made here ends with it
    joined = cfg.get("distributed", False) and not dist.is_initialized()
    if cfg.get("distributed", False):
        rank, world_size, device = init_distributed(backend, device)
    try:
        experiment = (experiment_cls or get_experiment(cfg.exp_type))(
            cfg, rank=rank, world_size=world_size, device=device)
        experiment()
        LOGGER.info("Run finished")
    finally:
        if joined:
            dist.destroy_process_group()
    return experiment


if __name__ == "__main__":
    main()

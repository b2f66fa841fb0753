"""CaloGAN fine-tuning (port of ``vit4hep_tpu/experiments/calogan_finetuning.py``):
the backbone swap and embedder surgery of :class:`FTMixin` on the CaloGAN
pipeline."""

from __future__ import annotations

from vit4hep_tpu_torch.experiments.calochallenge_finetuning import FTMixin
from vit4hep_tpu_torch.experiments.calogan import CaloGAN


class CaloGANFTCFM(FTMixin, CaloGAN):
    pass

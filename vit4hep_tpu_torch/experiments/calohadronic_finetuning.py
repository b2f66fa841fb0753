"""CaloHadronic fine-tuning from a LEMURS backbone (port of
``vit4hep_tpu/experiments/calohadronic_finetuning.py``): the backbone swap
and embedder surgery of :class:`FTMixin`. The fixed LEMURS conditions
(``gen_theta``, ``gen_phi``, ``gen_label``) follow E in the shape model's
condition: the pipeline's ``AddLEMURSConditions`` appends them to the data
(and so to the test set's conditions), and with ``sample_us`` the sampled
conditions get them here, the energy model seeing E alone."""

from __future__ import annotations

from vit4hep_tpu_torch.experiments.calochallenge_finetuning import FTMixin
from vit4hep_tpu_torch.experiments.calohadronic import CaloHadronic


class CaloHadronicFT(FTMixin, CaloHadronic):
    energy_cond_width = 1

    def sampling_conditions(self, e_inc):
        cond = super().sampling_conditions(e_inc)
        return self.with_lemurs_conditions(cond) if "gen_theta" in self.cfg else cond

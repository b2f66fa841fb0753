"""LEMURS shape model (port of ``vit4hep_tpu/models/lemurs.py``).

CaloChallengeCFM's patching; LEMURS batches arrive as (B, H, W, L) and are
permuted to the CaloChallenge (B, 1, L, W, H) layout inside the loss.
"""

from __future__ import annotations

from vit4hep_tpu_torch.models.calochallenge import CaloChallengeCFM


class LEMURSCFM(CaloChallengeCFM):
    def batch_loss(self, x, c, generator=None, t=None, x_0=None, rows=None):
        """CaloChallengeCFM's loss on ``x`` (B, H, W, L) moved to (B, 1, L,
        W, H); ``t`` and ``x_0``, when given, are in the moved layout."""
        return super().batch_loss(x.permute(0, 3, 2, 1)[:, None], c, generator, t, x_0, rows)

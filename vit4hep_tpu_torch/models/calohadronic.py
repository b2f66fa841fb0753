"""CaloHadronic shape model (port of ``vit4hep_tpu/models/calohadronic.py``).

The joint ECal + HCal shower: ECal 10x15x15 (2250 voxels) and HCal
48x30x30 (43,200) concatenated on the flat voxel axis and patched per
section (``list_edges: [2250, 43200]``) into 30 + 576 = 606 tokens.
"""

from __future__ import annotations

from vit4hep_tpu_torch.models.calogan import CaloGANCFM


class CaloHadCFM(CaloGANCFM):
    """CaloGANCFM's multi-section patching; its own class for the configs'
    ``_target_``."""

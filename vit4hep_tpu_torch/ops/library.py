"""The hand-written kernels that a traced program holds as custom ops
(``torch.library.custom_op``, namespace ``vit4hep``), registered when
their modules are imported; importing this module registers them all, as
loading a ``torch.export`` artifact (``utils/serving.load_sampler``) needs.

Each op's implementation launches the kernel on CUDA tensors, and adds one
to the kernel's launch counter there, when it runs (never when it is
traced), and runs the kernel's plain version on CPU tensors; a fake
implementation gives the shapes to the tracer. A wrapper records its op
only when traced (``_cuda.tracing``); eager calls launch as before.

- ``vit4hep::energy_decoder``: K3, ``ops/fused_energy_decoder.py``;
- ``vit4hep::vit_gemm``, ``vit_modln``, ``vit_attention``: K2v's
  launches, ``ops/fused_dit_block.py`` (a traced ``fused_vit_forward``
  is the card's sequence of them, on any device);
- ``vit4hep::binned_rqs_inverse``: K4, ``ops/fused_spline.py`` (its
  scratch and epoch taken at each call);
- ``vit4hep::qkv_attention_fwd``: K1's forward,
  ``ops/fused_qkv_attention.py``.
"""

from vit4hep_tpu_torch.ops import (fused_dit_block, fused_energy_decoder,  # noqa: F401
                                   fused_qkv_attention, fused_spline)

OPS = ("energy_decoder", "vit_gemm", "vit_modln", "vit_attention", "binned_rqs_inverse",
       "qkv_attention_fwd")

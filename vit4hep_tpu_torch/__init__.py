"""PyTorch + CUDA port of vit4hep_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (``ops/``, ``models/``, ``experiments/``,
``utils/``, ``data/``): each module here is the counterpart of the module of
the same name in ``vit4hep_tpu``. The JAX package stays the reference; this
package imports ``torch`` and never ``jax``, ``flax`` or ``optax``, nor the
JAX package itself. Its entry points: ``utils/serving.Generator`` (ds2
generation, on the device of the models it is given) and the launcher
``python -m vit4hep_tpu_torch.experiments.main`` (training, on the CUDA
device unless ``device=cpu`` is asked for).

Every Pallas kernel on a ported path has a hand-written CUDA C++ counterpart
in ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use and loaded with
``ctypes`` (``ops/_cuda.py``). Beside each kernel sits its plain PyTorch
version: a wrapper given CPU tensors runs the plain version, given CUDA
tensors it launches the kernel or raises.
"""

"""Shower generation for serving (port of ``vit4hep_tpu/utils/serving.py``).

:class:`Generator` runs the two-stage chain in process:
``generator(cond, seed)`` returns showers in the shape model's training
basis, ``generator.sample_showers(E_inc, seed)`` MeV voxels through the
host transform pipeline.

:func:`export_generator` (the whole chain: energy model, the u mapping on
the device, shape model) and :func:`export_sampler` (one model's
``sample_batch``) write the same program as one self-contained artifact,
with the parameters and the transforms' constants baked in: a
``torch.export`` program (``strict=False``, traced under ``torch.no_grad``)
saved by ``torch.export.save``. The hand-written kernels on the path are
registered custom ops (``ops/library.py``), held in the graph as opaque
nodes, one for each launch the live path makes; they launch, and count,
when the program runs. Loading needs the port's ops module and nothing
else of the repo: no model code, config or checkpoint layout.

The file keeps the JAX package's layout: ``VIT4HEP1``, a little-endian
``<I`` header length, the JSON header (JAX's fields, ``platforms`` the
device type, and ``"format": "torch.export"``), then the payload. So JAX's
``read_header`` reads a port artifact's header, and :func:`load_sampler`
refuses a JAX artifact by its missing format.

``torch.export`` takes no ``torch.Generator``: the program takes the noise
``(cond, energy_noise, shape_noise)`` (a sampler's ``(cond, noise)``), and
:class:`LoadedSampler` draws it from ``torch.Generator(device)
.manual_seed(seed)`` in the live path's order, energy first, so that
``artifact(cond, seed)`` equals ``Generator(cond, seed)``. The batch is
static, as in JAX: export one artifact per batch size served. An
artifact exported on the card runs only on a card.
"""

from __future__ import annotations

import contextlib
import io
import json
import struct
import typing

import numpy as np
import torch
from torch import nn

from vit4hep_tpu_torch.data.calochallenge.transforms import apply_pipeline
from vit4hep_tpu_torch.experiments.fused_chain import make_fused_generate

_MAGIC = b"VIT4HEP1"
FORMAT = "torch.export"


class Generator:
    """Fixed-batch two-stage generator over an energy model and a shape
    model (a CFM or cINN of any family), with their transform pipelines.
    ``u_position`` and ``energy_cond_width`` give the family's condition
    layout (``experiments/fused_chain.make_fused_generate``); the condition
    a call takes is the shape model's less the u's. :meth:`condition` and
    :meth:`sample_showers` run CaloChallenge's array steps
    (``vit4hep_tpu_torch.data.calochallenge.transforms``); the other
    families' experiments reverse their dict steps themselves."""

    def __init__(self, shape_model, energy_model, energy_transforms, shape_transforms,
                 batch: int, u_position="first", energy_cond_width=None):
        self.shape_model = shape_model
        self.energy_model = energy_model
        self.energy_transforms = list(energy_transforms)
        self.shape_transforms = list(shape_transforms)
        self.u_position, self.energy_cond_width = u_position, energy_cond_width
        self.batch = int(batch)
        self._generate = make_fused_generate(shape_model, energy_model, energy_transforms,
                                             shape_transforms, u_position, energy_cond_width)
        self.cond_dim = int(shape_model.condition_dim) - int(energy_model.shape[0])

    @property
    def device(self) -> torch.device:
        return self.shape_model.device

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def generate(self, cond, seed: int = 0, noise=None):
        """(shower, full_cond) for a (batch, cond_dim) transformed condition."""
        cond = torch.as_tensor(cond, dtype=torch.float32, device=self.device)
        if tuple(cond.shape) != (self.batch, self.cond_dim):
            raise ValueError(f"generator was built for cond shape ({self.batch}, "
                             f"{self.cond_dim}), got {tuple(cond.shape)}")
        return self._generate(cond, generator=self._generator(seed), noise=noise)

    def __call__(self, cond, seed: int = 0, noise=None):
        """Showers in the shape model's training basis, (batch, *x_shape)."""
        return self.generate(cond, seed, noise)[0]

    def condition(self, e_inc_mev) -> np.ndarray:
        """The transformed condition for incident energies in MeV: the shape
        pipeline's ``cond_transform`` steps, forward."""
        cond = np.asarray(e_inc_mev, np.float32).reshape(-1, 1)
        for fn in self.shape_transforms:
            if hasattr(fn, "cond_transform"):
                _, cond = fn(None, cond)
        return cond

    def sample_showers(self, e_inc_mev, seed: int = 0, noise=None) -> np.ndarray:
        """MeV voxels (batch, n_voxels) for incident energies in MeV: the
        condition transformed, generation, the channel dropped, then every
        shape transform reversed, in reverse order."""
        shower, full_cond = self.generate(self.condition(e_inc_mev), seed, noise)
        samples, _ = apply_pipeline(self.shape_transforms, shower.cpu().numpy()[:, 0],
                                    full_cond.cpu().numpy(), rev=True)
        return samples


def noise_shape(model, batch: int) -> tuple:
    """The shape of ``model.sample_batch``'s noise: a patching CFM's token
    shape, else the model's x shape (a CFM's ``x_T``, a cINN's ``z``)."""
    tokens = getattr(model, "token_shape", lambda _b: None)(batch)
    return tuple(int(s) for s in (tokens or model.x_shape(batch)))


class _Chain(nn.Module):
    """The two-stage chain on given noise: ``(cond, energy_noise,
    shape_noise) -> showers``."""

    def __init__(self, shape_model, energy_model, energy_transforms, shape_transforms,
                 u_position, energy_cond_width):
        super().__init__()
        self.shape_model, self.energy_model = shape_model, energy_model
        self._generate = make_fused_generate(shape_model, energy_model, energy_transforms,
                                             shape_transforms, u_position, energy_cond_width)

    def forward(self, cond, energy_noise, shape_noise):
        return self._generate(cond, noise=(energy_noise, shape_noise))[0]


class _Sampler(nn.Module):
    """One model's ``sample_batch`` on given noise: ``(cond, noise) ->
    samples``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, cond, noise):
        return self.model.sample_batch(cond, None, noise)


def _trace(module, device, batch, cond_dim, noise_shapes, header):
    """(``module`` exported on zeros of the call's shapes, ``header``
    completed with the shapes)."""
    args = (torch.zeros((batch, cond_dim), device=device),
            *(torch.zeros(s, device=device) for s in noise_shapes))
    with torch.no_grad(), _no_stack_traces():
        program = torch.export.export(module, args, strict=False)
    (out,) = next(n for n in program.graph.nodes if n.op == "output").args[0]
    header = {"version": 1, **header, "batch": int(batch), "cond_dim": int(cond_dim),
              "out_shape": [int(s) for s in out.meta["val"].shape],
              "platforms": [torch.device(device).type],
              "noise_shapes": [list(s) for s in noise_shapes], "format": FORMAT}
    return program, header


def artifact_bytes(program, header) -> bytes:
    """The artifact file: the magic, the header and the saved program."""
    payload = io.BytesIO()
    torch.export.save(program, payload)
    hdr = json.dumps(header).encode()
    return _MAGIC + struct.pack("<I", len(hdr)) + hdr + payload.getvalue()


def trace_sampler(model, batch: int, *, cond_dim: int | None = None, meta: dict | None = None):
    """(program, header) of :func:`export_sampler`."""
    cond_dim = int(model.condition_dim) if cond_dim is None else int(cond_dim)
    return _trace(_Sampler(model), model.device, batch, cond_dim, [noise_shape(model, batch)],
                  {"kind": "sampler", "model": type(model).__name__, "meta": meta or {}})


def trace_generator(shape_model, energy_model, energy_transforms, shape_transforms, batch: int,
                    *, cond_dim: int | None = None, u_position="first", energy_cond_width=None,
                    meta: dict | None = None):
    """(program, header) of :func:`export_generator`."""
    if cond_dim is None:
        cond_dim = int(shape_model.condition_dim) - int(energy_model.shape[0])
    module = _Chain(shape_model, energy_model, energy_transforms, shape_transforms, u_position,
                    energy_cond_width)
    header = {"kind": "generator", "u_position": str(u_position),
              "energy_cond_width": None if energy_cond_width is None else int(energy_cond_width),
              "model": f"{type(energy_model).__name__}+{type(shape_model).__name__}",
              "meta": meta or {}}
    return _trace(module, shape_model.device, batch, cond_dim,
                  [noise_shape(energy_model, batch), noise_shape(shape_model, batch)], header)


def export_sampler(model, batch: int, **kwargs) -> bytes:
    """The artifact of ``model.sample_batch`` for ``batch`` conditions
    (``sampler(cond, seed)``), with the model's parameters baked in;
    ``cond_dim`` (the model's by default) and ``meta`` by keyword."""
    return artifact_bytes(*trace_sampler(model, batch, **kwargs))


def export_generator(shape_model, energy_model, energy_transforms, shape_transforms,
                     batch: int, **kwargs) -> bytes:
    """The artifact of the whole two-stage chain (:class:`Generator`'s) for
    ``batch`` conditions: ``generate(cond, seed) -> showers`` in the shape
    model's training basis, both models' parameters and the u mapping's
    constants baked in. By keyword: ``u_position`` and ``energy_cond_width``
    (the family's condition layout), ``cond_dim`` (by default the shape
    model's condition less the energy model's u's) and ``meta``."""
    return artifact_bytes(*trace_generator(shape_model, energy_model, energy_transforms,
                                           shape_transforms, batch, **kwargs))


def _write(path, blob) -> dict:
    with open(path, "wb") as f:
        f.write(blob)
    return read_header(path)


def save_generator(path, *args, **kwargs) -> dict:
    """:func:`export_generator` into ``path``; returns its header."""
    return _write(path, export_generator(*args, **kwargs))


def save_sampler(path, model, batch: int, **kwargs) -> dict:
    """:func:`export_sampler` into ``path``; returns its header."""
    return _write(path, export_sampler(model, batch, **kwargs))


def read_header(path) -> dict:
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise ValueError(f"{path} is not a vit4hep sampler artifact")
        (n,) = struct.unpack("<I", f.read(4))
        return json.loads(f.read(n).decode())


class LoadedSampler:
    """A loaded artifact: ``sampler(cond, seed)`` -> samples (a tensor on
    the artifact's device), the noise drawn from ``seed`` as the live path
    draws it; ``header`` has the shapes and the metadata of the export."""

    def __init__(self, header: dict, program):
        self.header = header
        self.program = program
        self.device = torch.device(header["platforms"][0])
        self._module = program.module()

    @property
    def batch(self) -> int:
        return self.header["batch"]

    @property
    def cond_dim(self) -> int:
        return self.header["cond_dim"]

    def noise(self, seed: int = 0) -> list:
        """The program's noise for ``seed``: each stage's, in order, from one
        ``torch.Generator`` on the device."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return [torch.randn(tuple(s), generator=gen, device=self.device, dtype=torch.float32)
                for s in self.header["noise_shapes"]]

    def __call__(self, cond, seed: int = 0, noise=None):
        cond = torch.as_tensor(cond, dtype=torch.float32, device=self.device)
        if tuple(cond.shape) != (self.batch, self.cond_dim):
            raise ValueError(f"artifact was exported for cond shape ({self.batch}, "
                             f"{self.cond_dim}), got {tuple(cond.shape)}")
        noise = self.noise(seed) if noise is None else noise
        with torch.no_grad():
            return self._module(cond, *noise)


def load_sampler(path) -> LoadedSampler:
    """The artifact at ``path``. Refuses a file of another format (a JAX
    ``jax.export`` artifact) and, on a host without a card, an artifact
    exported on the card."""
    header = read_header(path)
    if header.get("format") != FORMAT:
        raise ValueError(f"{path} is a {header.get('format', 'jax.export')} artifact, not a "
                         f"{FORMAT} one: the port cannot run it")
    if header["platforms"][0] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported on a CUDA device and runs only on one; this "
                           "host has none")
    from vit4hep_tpu_torch.ops import library  # noqa: F401  registers the kernels' ops

    with open(path, "rb") as f:
        f.seek(12 + struct.unpack("<I", f.read(12)[8:])[0])
        payload = io.BytesIO(f.read())
    with _type_hints_once():
        program = torch.export.load(payload)
    return LoadedSampler(header, program)


@contextlib.contextmanager
def _no_stack_traces():
    """The tracer records no Python stack for each node: an unrolled chain
    has tens of thousands, and their stacks took a quarter of the export
    and of the file."""
    config = torch.fx.config
    saved = getattr(config, "do_not_emit_stack_traces", None)
    config.do_not_emit_stack_traces = True
    try:
        yield
    finally:
        if saved is None:
            del config.do_not_emit_stack_traces
        else:
            config.do_not_emit_stack_traces = saved


@contextlib.contextmanager
def _type_hints_once():
    """``typing.get_type_hints`` answering each question once: the
    ``torch.export`` deserializer asks it about the same few schema classes
    for every node of the graph, which took most of a load's time."""
    ask, answers = typing.get_type_hints, {}

    def hints(obj, globalns=None, localns=None, include_extras=False):
        key = (obj, id(globalns), id(localns), include_extras)
        if key not in answers:
            answers[key] = ask(obj, globalns, localns, include_extras)
        return answers[key]

    typing.get_type_hints = hints
    try:
        yield
    finally:
        typing.get_type_hints = ask

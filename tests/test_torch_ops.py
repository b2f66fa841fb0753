"""Port parity of the small modules (vit4hep_tpu_torch.ops / models.trajectories)
against the JAX package, on the CPU in float32.

Inputs come from numpy with a seed and go through both implementations.
Tolerance: float32 elementwise ops in another order (torch vs XLA) agree to
a few ulp, so atol=2e-5, rtol=1e-5 (the bound tests/test_energy_fused.py
uses) unless a test states otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit4hep_tpu.models import trajectories as jtraj
from vit4hep_tpu.ops import attention as jattn
from vit4hep_tpu.ops import ode as jode
from vit4hep_tpu.ops import patching as jpatch
from vit4hep_tpu.ops import pos_embed as jpe
from vit4hep_tpu_torch.models import trajectories as ttraj
from vit4hep_tpu_torch.ops import attention as tattn
from vit4hep_tpu_torch.ops import ode as tode
from vit4hep_tpu_torch.ops import patching as tpatch
from vit4hep_tpu_torch.ops import pos_embed as tpe

ATOL, RTOL = 2e-5, 1e-5


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(port.detach().cpu()), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dim", [256, 33])
def test_timestep_embedding(dim):
    t = np.random.default_rng(0).uniform(0, 1, (7, 1)).astype(np.float32)
    _close(tpe.timestep_embedding(torch.from_numpy(t), dim), jpe.timestep_embedding(jnp.asarray(t), dim))


def test_gaussian_fourier_projection():
    rng = np.random.default_rng(1)
    t = rng.uniform(0, 1, (6, 1)).astype(np.float32)
    w = (rng.normal(size=(32,)) * 30).astype(np.float32)
    # |t * w * 2pi| reaches ~500 rad: sin/cos of float32 arguments that large
    # differ by ~1 ulp of the argument between libms, hence atol 1e-4
    _close(tpe.gaussian_fourier_projection(torch.from_numpy(t), torch.from_numpy(w)),
           jpe.gaussian_fourier_projection(jnp.asarray(t), jnp.asarray(w)), atol=1e-4)


def test_learnable_fourier_pos_embed_3d():
    grid = ((15, 1, 9),)
    for a, b in zip(tpe.create_meshgrid(grid), jpe.create_meshgrid(grid)):
        np.testing.assert_array_equal(a, b)
    freqs = np.random.default_rng(2).normal(size=(80,)).astype(np.float32)
    pz, py, px = tpe.create_meshgrid(grid)
    port = tpe.learnable_fourier_pos_embed_3d(torch.from_numpy(freqs), *map(torch.from_numpy, (pz, py, px)))
    ref = jpe.learnable_fourier_pos_embed_3d(jnp.asarray(freqs), *map(jnp.asarray, (pz, py, px)))
    _close(port, ref)


def test_layer_causal_mask():
    np.testing.assert_array_equal(tpe.layer_causal_mask((3, 2, 2)), jpe.layer_causal_mask((3, 2, 2)))


# ds2 (3, 16, 1), a tiny ds2-like shape, ds3's (3, 10, 3) patch on 45 x 50 x
# 18 voxels and a tiny ds3-like one: every patch dim > 1 splits the radial axis
@pytest.mark.parametrize("shape,patch", [((45, 16, 9), (3, 16, 1)), ((6, 4, 3), (3, 2, 1)),
                                         ((45, 50, 18), (3, 10, 3)), ((6, 4, 6), (3, 2, 3))])
def test_patching_token_order_bit_exact(shape, patch):
    x = np.random.default_rng(3).normal(size=(2, 1, *shape)).astype(np.float32)
    tok_t = tpatch.to_patches(torch.from_numpy(x), patch)
    tok_j = np.asarray(jpatch.to_patches(jnp.asarray(x), patch))
    np.testing.assert_array_equal(tok_t.numpy(), tok_j)
    num = tuple(s // p for s, p in zip(shape, patch))
    np.testing.assert_array_equal(tpatch.from_patches(tok_t, num, patch).numpy(), x)


def test_check_divisible():
    tpatch.check_divisible((45, 16, 9), (3, 16, 1))
    with pytest.raises(AssertionError):
        tpatch.check_divisible((45, 16, 9), (4, 16, 1))


def _ode_rhs(lib):
    def f(t, y):
        return lib.sin(3.0 * y) * (1.0 + t) - 0.5 * y
    return f


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4", "rk4_classic"])
@pytest.mark.parametrize("step", [0.25, 0.3])
def test_odeint_matches_jax(method, step):
    """step 0.3 leaves a truncated final step of 0.1 on [0, 1]."""
    y0 = np.random.default_rng(4).normal(size=(5, 3)).astype(np.float32)
    port = tode.odeint(_ode_rhs(torch), torch.from_numpy(y0), method=method, step_size=step)
    ref = jode.odeint(_ode_rhs(jnp), jnp.asarray(y0), method=method, step_size=step)
    # up to 16 chained f32 stages: a few ulp per stage
    _close(port, ref, atol=1e-5, rtol=1e-5)


def test_ode_grid_helpers():
    for step in (0.05, 0.25, 0.3, 0.7):
        assert tode.grid_steps(step) == jode.grid_steps(step)
        assert tode._grid_plan(step, 0.0, 1.0) == jode._grid_plan(step, 0.0, 1.0)
    kw = {"method": "rk4", "options": {"step_size": 0.05, "unroll": 3}}
    assert tode.parse_odeint_kwargs(kw) == jode.parse_odeint_kwargs(kw)
    assert tode.NET_EVALS_PER_STEP == jode.NET_EVALS_PER_STEP
    with pytest.raises(ValueError):
        tode.odeint(_ode_rhs(torch), torch.zeros(1), method="dopri5")


@pytest.mark.parametrize("masked", [False, True])
def test_attention_matches_jax(masked):
    rng = np.random.default_rng(5)
    qkv = rng.normal(size=(2, 12, 3 * 4 * 8)).astype(np.float32)
    mask = np.tril(np.ones((12, 12), bool)) if masked else None
    port = tattn.qkv_attention(torch.from_numpy(qkv), 4,
                               mask=None if mask is None else torch.from_numpy(mask))
    ref = jattn.qkv_attention(jnp.asarray(qkv), 4, mask=None if mask is None else jnp.asarray(mask),
                              impl="xla")
    _close(port, ref)
    with pytest.raises(ValueError):
        tattn.qkv_attention(torch.from_numpy(qkv), 4, impl="nope")


@pytest.mark.parametrize("name", sorted(jtraj.TRAJECTORIES))
def test_trajectories_match_jax(name):
    rng = np.random.default_rng(6)
    x0, x1 = (rng.normal(size=(4, 5)).astype(np.float32) for _ in range(2))
    t = rng.uniform(0.05, 0.95, (4, 1)).astype(np.float32)
    port = ttraj.get_trajectory(name)(*map(torch.from_numpy, (x0, x1, t)))
    ref = jtraj.get_trajectory(name)(*map(jnp.asarray, (x0, x1, t)))
    for a, b in zip(port, ref):
        _close(a, b, atol=1e-4, rtol=1e-5)  # vp: exp/sqrt chains, |values| up to ~1e2


def test_kernel_library_digest_follows_included_headers(tmp_path, monkeypatch):
    """A library's digest covers its source and every local header it
    includes (through other headers too): editing any of them names a new
    library, so a stale one is never loaded."""
    from vit4hep_tpu_torch.ops import _cuda

    # K1 and K7 share the forward header, reaching it through the backward
    # tiles' header; the ViT GEMM, K2v's attention, K5b's products and K6's
    # forward share the Hopper primitives, K2v's attention, K5b and K6
    # reaching them through their wgmma headers too
    for name, headers in (("vit_forward", ["hopper.cuh", "vit_attention_wgmma.cuh"]),
                          ("vit_backward", ["bwd_wgmma.cuh", "hopper.cuh"]),
                          ("qkv_attention", ["attention_bwd.cuh", "attention_fwd.cuh"]),
                          ("flash_attention", ["attention_bwd.cuh", "attention_fwd.cuh"]),
                          ("flash_qkv_attention", ["attention_mma.cuh", "attention_wgmma.cuh",
                                                   "hopper.cuh"])):
        assert [p.name for p in _cuda.sources_of(name)] == [f"{name}.cu", *headers]
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("int b = 1;\n")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    assert [p.name for p in _cuda.sources_of("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = _cuda._lib_path("k")
    assert _cuda._lib_path("k") == first
    (tmp_path / "b.cuh").write_text("int b = 2;\n")
    second = _cuda._lib_path("k")
    assert second != first and second.name.startswith("libk-")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// edited\n')
    assert _cuda._lib_path("k") not in (first, second)

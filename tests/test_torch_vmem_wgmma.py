"""K8 (``vmem_attention``) on its wgmma kernels (``csrc/vmem_wgmma.cuh``):
the forward ``vmem_fwd_wgmma_kernel`` (128 query rows a CTA, two sweeps over
64-key tiles), the dQ pass ``vmem_bwd_dq_wgmma_kernel`` (128 query rows; it
writes dQ and K8's own row term rowsum(dp * p)) and the dK/dV pass
``vmem_bwd_dkv_wgmma_kernel`` (128 key rows; 64-query tiles with their lse
and row term).

CPU tests: the smoke's record of K8 (``chip_smoke.REPLACES`` names the new
kernels in files that exist; its ds3 training profile's groups give K8's
forward and backward kernels, K6's and K1's each a group of their own).
K8's plain versions (``mm_dtype`` f32) against JAX's
``vmem_attention`` in interpret mode at the kernels' tile edges: N = 130 (a
2-row tail past the 128-row blocks and the 64-key tiles, as ds3's 450 = 7 x
64 + 2) and N = 200 (a 72-row tail block, an 8-key tail tile); unmasked,
layer-causal, and with the last row wholly masked (in both tails). The
forward, the lse and the gradients of sum(out^2) at atol 2e-5 and 1e-4 (f32
on both sides, summation order only), as ``tests/test_torch_flash_vmem.py``
holds N = 40.

CUDA tests (marker ``cuda``; they skip without a card) hold each kernel
against its plain version on the same bf16 roundings (``mm_dtype`` bf16:
summation order and ``__expf`` only), with ``chip_smoke.TOL``'s bounds of
the scale max(1, max|plain|): 2e-3 for the forward, 4e-3 for dQ, the row
term, dK and dV; the lse 1e-4 (f32 sums only). Shapes: the flash/vmem
file's ``CUDA_SHAPES`` plus N = 1 and 65 at d = 80, d = 13 and 33 (the
4-byte copy path) and d = 128 (the one-stage ring of the dK/dV pass); q, k
and v are strided views of a qkv panel and the upstream gradient a strided
view of the merged one; each wrapper counts exactly one launch. The
forward unmasked and with an all-True mask is held against an f64 softmax
of the same bf16 operands at every padded head dim (the two arms round the
exponent in another order, so they need not agree bit for bit).
On the card: ``python -m pytest --noconftest -m cuda tests/test_torch_vmem_wgmma.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

try:  # the JAX reference; the card's machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    from vit4hep_tpu.ops import vmem_attention as jvmem
except ModuleNotFoundError:
    jax = None

from vit4hep_tpu_torch.ops import vmem_attention as tvmem
from vit4hep_tpu_torch.ops.pos_embed import layer_causal_mask

FWD_ATOL, GRAD_ATOL = 2e-5, 1e-4
MASK_KINDS = ["none", "layer_causal", "dead_row"]
LAYER_GRIDS = {130: (13, 2, 5), 200: (8, 5, 5), 135: (15, 1, 9), 450: (15, 5, 6)}


def _mask(kind, n):
    """None, the layer-causal mask of a token grid with n tokens (causal
    where none is listed), or a causal mask whose last row attends to no
    key."""
    if kind == "none":
        return None
    if kind == "layer_causal":
        return layer_causal_mask(LAYER_GRIDS[n]) if n in LAYER_GRIDS else \
            np.tril(np.ones((n, n), bool))
    mask = np.tril(np.ones((n, n), bool))
    mask[n - 1] = False
    return mask


ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_vmem_wgmma", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# kernel names as torch.profiler gives them, and the group each belongs to
PROFILE_NAMES = {
    "void aw::vmem_fwd_wgmma_kernel<80, false>(amma::Args)": "K8 forward",
    "void aw::vmem_fwd_wgmma_kernel<80, true>(amma::Args)": "K8 forward",
    "void aw::vmem_bwd_dq_wgmma_kernel<80, false>(amma::Args)": "K8 backward",
    "void aw::vmem_bwd_dkv_wgmma_kernel<80, true>(amma::Args)": "K8 backward",
    "void aw::flash_fwd_wgmma_kernel<80, false>(amma::Args)": "K6 forward",
    "void aw::flash_bwd_dq_wgmma_kernel<80, false>(amma::Args)": "K6 backward",
    "void aw::flash_bwd_dkv_wgmma_kernel<80, true>(amma::Args)": "K6 backward",
    "void tf::qkv_fwd_tf32_kernel<80, 1, false>(float const*, unsigned char const*, float*, "
    "float*, int, int, int, float)": "K1 forward",
    "void (anonymous namespace)::bwd_dq_kernel<80, false>(Args)": "K1 backward",
}


@pytest.mark.parametrize("name", list(PROFILE_NAMES))
def test_smoke_profile_groups_tell_k8_from_k6(name):
    smoke = _chip_smoke()
    claims = [label for label, claims in smoke.DS3_TRAIN_GROUPS if claims(name)]
    assert claims and claims[0] == PROFILE_NAMES[name], claims


@pytest.mark.parametrize("kernel", ["vmem_attn_fwd", "vmem_attn_bwd_dq", "vmem_attn_bwd_dkv"])
def test_smoke_names_the_wgmma_kernels(kernel):
    smoke = _chip_smoke()
    source, replaces = smoke.REPLACES[kernel]
    want = {"vmem_attn_fwd": "vmem_fwd_wgmma_kernel",
            "vmem_attn_bwd_dq": "vmem_bwd_dq_wgmma_kernel",
            "vmem_attn_bwd_dkv": "vmem_bwd_dkv_wgmma_kernel"}[kernel]
    assert want in source and "attention_mma" not in source
    header = ROOT / source.split()[0]
    assert header.exists() and f"{want}(Args a)" in header.read_text()
    assert replaces.startswith("vit4hep_tpu/ops/vmem_attention.py:")
    assert smoke.TOL[kernel] == (2e-3 if kernel == "vmem_attn_fwd" else 4e-3)


# ---------------------------------------------------------------------------
# K8's plain versions at the kernels' tile edges (CPU, against JAX)
# ---------------------------------------------------------------------------
@pytest.mark.skipif(jax is None, reason="needs JAX (the reference)")
@pytest.mark.parametrize("n", [130, 200])
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_vmem_plain_at_the_kernel_tiles_matches_jax(n, kind):
    b, h, d = 2, 2, 16
    rng = np.random.default_rng(80 + n)
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(3))
    mask = _mask(kind, n)
    jmask = None if mask is None else jnp.asarray(mask)
    out_j, res = jvmem._vmem_fwd(*map(jnp.asarray, (q, k, v)), jmask)
    grads_j = jax.grad(lambda *x: jnp.sum(jvmem.vmem_attention(*x, jmask) ** 2),
                       argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    tmask = None if mask is None else torch.from_numpy(mask)
    xs = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = tvmem.vmem_attention(*xs, tmask)
    grads = torch.autograd.grad((out ** 2).sum(), xs)
    _, lse = tvmem.vmem_fwd_plain(*map(torch.from_numpy, (q, k, v)), d ** -0.5, tmask)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[5]).reshape(b, h, n), atol=FWD_ATOL)
    for name, got, want in zip("qkv", grads, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_ATOL,
                                   err_msg=f"d{name}")
    if kind == "dead_row":  # the mean of V over the n keys, lse -1e30
        np.testing.assert_allclose(out.detach().numpy()[:, :, n - 1], v.mean(2), atol=FWD_ATOL)
        assert (lse.numpy()[:, :, n - 1] == np.float32(-1e30)).all()


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------
CUDA_SHAPES = [(3, 6, 135, 80), (2, 6, 450, 80), (2, 3, 65, 33), (1, 2, 1, 16),
               (2, 1, 130, 128), (2, 2, 1, 80), (2, 3, 65, 80), (2, 3, 70, 13),
               (1, 2, 200, 128)]
TOL = {"fwd": 2e-3, "bwd": 4e-3, "lse": 1e-4}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, 'PyTorch port')")
    return torch.device("cuda")


def _close(got, want, tol, what):
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    assert err <= tol * scale, f"{what}: max abs error {err:.3e} > {tol} x {scale:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,d", CUDA_SHAPES)
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_vmem_wgmma_kernels_match_plain_on_cuda(cuda_device, b, h, n, d, kind):
    gen = torch.Generator(device=cuda_device).manual_seed(90 + n + d)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=cuda_device)
    g = torch.randn(b, n, h * d, generator=gen, device=cuda_device)
    q, k, v = qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)  # strided views
    gh = g.reshape(b, n, h, d).permute(0, 2, 1, 3)
    mask = _mask(kind, n)
    mask = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    scale, bf = d ** -0.5, torch.bfloat16
    counters = (tvmem.FWD, tvmem.BWD_DQ, tvmem.BWD_DKV)
    counts = [c.launches for c in counters]

    out, lse = tvmem.vmem_fwd_kernel(q, k, v, scale, mask)
    torch.cuda.synchronize()
    out_p, lse_p = tvmem.vmem_fwd_plain(q, k, v, scale, mask, bf)
    _close(out, out_p, TOL["fwd"], "out")
    _close(lse, lse_p, TOL["lse"], "lse")

    dq, rowterm = tvmem.vmem_bwd_dq_kernel(q, k, v, gh, lse, scale, mask)
    dk, dv = tvmem.vmem_bwd_dkv_kernel(q, k, v, gh, lse, rowterm, scale, mask)
    torch.cuda.synchronize()
    assert [c.launches - k0 for c, k0 in zip(counters, counts)] == [1, 1, 1]
    # K8's own row term on the same bf16 products: rowsum(dp * p)
    s = tvmem._scores(q, k, scale, mask, bf)
    p = torch.exp(s - lse[..., None])
    rt_p = (tvmem._mm(gh, v.transpose(-1, -2), bf) * p).sum(-1)
    _close(rowterm, rt_p, TOL["bwd"], "row term")
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv),
                               tvmem.vmem_bwd_plain(q, k, v, gh, lse, scale, mask, bf)):
        _close(got, want, TOL["bwd"], name)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
def test_vmem_masked_forward_against_f64_on_cuda(cuda_device, d):
    """K8's forward unmasked and with an all-True mask, each against an f64
    softmax of the same bf16 operands within the forward's 2e-3 of the
    scale. The two arms need not agree bit for bit: the unmasked arm fuses
    s * scale - max into one FFMA, the masked arm rounds s * scale before it
    selects it or -1e30 and subtracts the max, so an exponent may differ in
    its last bit and p round to the other bf16 neighbour."""
    b, h, n = 2, 2, 200
    gen = torch.Generator(device=cuda_device).manual_seed(90 + d)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=cuda_device)
    q, k, v = qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    scale = d ** -0.5
    q16, k16, v16 = (t.to(torch.bfloat16).double() for t in (q, k, v))
    ref = torch.softmax(q16 @ k16.transpose(-1, -2) * scale, -1) @ v16
    ones = torch.ones(n, n, dtype=torch.bool, device=cuda_device)
    for mask in (None, ones):
        _close(tvmem.vmem_fwd_kernel(q, k, v, scale, mask)[0], ref, TOL["fwd"],
               f"d = {d}, {'all-True' if mask is not None else 'unmasked'}")

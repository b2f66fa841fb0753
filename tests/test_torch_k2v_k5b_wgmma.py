"""K2v's attention and K5b's two products on wgmma: ``vit_attn_wgmma_kernel``
(``csrc/vit_attention_wgmma.cuh``: 64 to 192 query rows a CTA, 64-key K/V
tiles through a cp.async ring, an online softmax, a bf16 context), and
``nt_wgmma_kernel`` / ``tn_wgmma_kernel`` (``csrc/bwd_wgmma.cuh``: the
activation gradients dY W^T and the split-K weight gradients A^T dY on TMA
rings, bf16 operands).

CPU tests:
- K2v's plain attention (f32) against the attention of JAX's whole-ViT
  kernel (``_attn_merged``, the function the Pallas body calls; f32 products)
  at tail token counts past the kernel's tiles (N = 130: a 2-key tail past
  64-key tiles; N = 200: an 8-key tail, and a 8-row tail past 192-row CTAs),
  unmasked, layer-causal and with the last row wholly masked (its context
  the mean of V), for the per-head (d = 80) and head-packed (d = 16) JAX
  forms: the plain context is the JAX context rounded to bf16 (within one
  bf16 ulp); the tiled online-softmax form the kernel takes (K6's plain
  forward over 64-key tiles, here on f32 multiplicands) agrees with JAX at
  atol 2e-5. And JAX's ``fused_vit_forward`` in interpret mode at N = 130
  (depth 1, the dead-row mask too) against the port's, atol 2e-5.
- The products' planning (``nt_plan``, ``tn_plan``, ``_split``,
  ``column_parts``): operands cast once to bf16 and zero-padded to 8-column
  multiples (the products unchanged), the split chosen for 132 SMs, what
  raises; ``gemm_nt_plain``'s side outputs
  (bf16 of the output and of gelu(a1)); the bias gradient taken from the
  f32 dY, never from its bf16 copy.
- The smoke's records: ``REPLACES`` names the new kernels in files that
  exist, the CFM and fused-training profile groups claim exactly them.
- Head dims above 128 raise NotImplementedError naming ROADMAP.md at both
  argument checks (on the CPU the wrappers run their plain versions and never
  reach them, so the checks are called directly).

CUDA tests (marker ``cuda``; they skip without a card): each kernel against
its plain version on the same bf16 roundings, under ``chip_smoke.TOL``'s
bounds of the scale max(1, max|plain|): the attention 8e-3 (its bf16 output
is one rounding), at N = 1, 63, 65, 130, 135, 200, 450 and d = 13, 16, 33, 80,
128, unmasked, layer-causal and with a dead row; the NT and TN products 1e-3
(f32 summation order) at odd M and K, with every epilogue, the NT's bf16
side outputs its own f32 output rounded once (bit for bit) and gelu(a1)
within one bf16 ulp of the plain f32 values, and dW and db of
two runs equal bit for bit. On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_k2v_k5b_wgmma.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

try:  # the JAX reference; the card's machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    from vit4hep_tpu.ops import fused_dit_block as jfdb
except ModuleNotFoundError:
    jax = None

from vit4hep_tpu_torch.ops import flash_qkv_attention as tffa
from vit4hep_tpu_torch.ops import fused_dit_block as tfdb
from vit4hep_tpu_torch.ops import fused_qkv_attention as tfqa
from vit4hep_tpu_torch.ops import vmem_attention as tvmem
from vit4hep_tpu_torch.ops.pos_embed import layer_causal_mask

ROOT = Path(__file__).resolve().parents[1]
ATOL = 2e-5
# gelu(a1) in f32 on the card against torch's: its tanh form cancels in the
# far negative tail (1 + tanh -> 0), where the two differ by ~1e-7 absolute
GELU_ATOL = 1e-6
MASK_KINDS = ["none", "layer_causal", "dead_row"]
LAYER_GRIDS = {130: (13, 2, 5), 200: (8, 5, 5), 135: (15, 1, 9), 450: (15, 5, 6)}
needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX (the reference)")


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


def _bf16_ulps(got, ref, atol=0.0):
    """The largest distance of bf16 values from f32 ones, past ``atol`` (how
    far the f32 values themselves may differ), in bf16 ulps of the f32
    value: at most 1 where ``got`` is those values rounded once."""
    ref = torch.as_tensor(ref).float()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    return (((torch.as_tensor(got).float() - ref).abs() - atol).clamp(min=0) / ulp).max().item()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_k2v_k5b", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# ---------------------------------------------------------------------------
# K2v's attention: the plain version against JAX at tail token counts
# ---------------------------------------------------------------------------
def _jax_attention(qkv, mask, heads, d):
    """JAX's whole-ViT kernel body's attention, element by element, f32."""
    def mm(a, w, dims=((1,), (0,))):
        return jax.lax.dot_general(a, w, (dims, ((), ())), preferred_element_type=jnp.float32,
                                   precision=jax.lax.Precision.HIGHEST)

    jmask = None if mask is None else jnp.asarray(mask)
    return np.stack([np.asarray(jfdb._attn_merged(jnp.asarray(x), jmask, heads, d, d ** -0.5, mm,
                                                  jnp.float32)) for x in qkv])


@needs_jax
@pytest.mark.parametrize("d", [16, 80], ids=["d16-packed", "d80-per-head"])
@pytest.mark.parametrize("n", [130, 200])
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_k2v_attention_plain_matches_jax_at_tail_n(n, kind, d):
    b, heads = 2, 2
    qkv = np.random.default_rng(n + d).normal(size=(b, n, 3 * heads * d)).astype(np.float32)
    mask = _mask(kind, n)
    want = _jax_attention(qkv, mask, heads, d)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = tfdb.attention_plain(torch.from_numpy(qkv), heads, d ** -0.5, tmask)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got, want, ATOL) <= 1.0  # the JAX context rounded once to bf16
    # the kernel's own form: 64-key tiles, online softmax, the pad guard
    tiled = tffa.flash_fwd_plain(torch.from_numpy(qkv), heads, d ** -0.5, tmask)[0]
    np.testing.assert_allclose(tiled.numpy(), want, atol=ATOL)
    if kind == "dead_row":  # a wholly masked row: the mean of V over the n keys
        v = qkv[:, :, 2 * heads * d:]
        np.testing.assert_allclose(want[:, n - 1], v.mean(1), atol=ATOL)


@needs_jax
@pytest.mark.parametrize("kind", ["none", "dead_row"])
def test_fused_vit_forward_at_tail_n_matches_jax_interpret(kind):
    """The whole forward at N = 130 (depth 1, hidden 48, 3 heads of 16)
    against JAX's ``_vit_kernel`` / ``_vit_kernel_masked`` in interpret
    mode."""
    rng = np.random.default_rng(11)
    b, n, pdim, h, fdim, out = 2, 130, 6, 48, 96, 6

    def w(*shape, s=0.1):
        return (rng.normal(size=shape) * s).astype(np.float32)

    args = [w(b, n, pdim, s=1.0), w(n, h, s=1.0), w(b, 1, 6, h), w(b, 2, h), w(pdim, h), w(h),
            w(1, h, 3 * h), w(1, 3 * h), w(1, h, h), w(1, h), w(1, h, fdim), w(1, fdim),
            w(1, fdim, h), w(1, h), w(h, out), w(out)]
    mask = _mask(kind, n)
    ref = jfdb.fused_vit_forward(*args, mask, 3, 16 ** -0.5, 1)
    port = tfdb.fused_vit_forward(*map(torch.from_numpy, args),
                                  None if mask is None else torch.from_numpy(mask), 3, None)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)


# ---------------------------------------------------------------------------
# K5b's products: their planning on the CPU
# ---------------------------------------------------------------------------
def _r(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("m,k,n", [(8640, 480, 1920), (37, 13, 21), (5, 8, 3)])
def test_nt_plan_casts_pads_and_keeps_the_product(m, k, n):
    rng = np.random.default_rng(m + k)
    a, w = _r(rng, m, k), _r(rng, n, k, dtype=torch.bfloat16)
    a16, w16, kind = tfdb.nt_plan("t", a, w)
    k8 = -(-k // 8) * 8
    assert a16.dtype == w16.dtype == torch.bfloat16 and a16.is_contiguous()
    assert tuple(a16.shape) == (m, k8) and tuple(w16.shape) == (n, k8) and kind == 0
    assert torch.equal(a16[:, :k], a.to(torch.bfloat16)) and not a16[:, k:].any()
    assert torch.equal(w16[:, :k], w) and not w16[:, k:].any()
    torch.testing.assert_close(a16.float() @ w16.float().t(), tfdb.gemm_nt_plain(a, w),
                               atol=1e-4, rtol=1e-5)
    b16, _, _ = tfdb.nt_plan("t", a.to(torch.bfloat16), w)
    assert torch.equal(b16, a16)  # a bf16 A is the same operand


@pytest.mark.parametrize("m,k,n,want", [
    (8640, 1920, 480, 2), (8640, 480, 1920, 2), (8640, 480, 480, 11), (8640, 480, 1440, 3),
    (7200, 480, 1440, 3), (7200, 8, 8, 15), (100, 8, 8, 2), (8640, 4096, 4096, 1)])
def test_split_is_the_sms_over_the_output_tiles(m, k, n, want):
    """S is how often the 128 x 160 output tiles of (k, n) fit on 132 SMs
    (1 to 16), taken in whole 64-row chunks: fewer where the rounding up to
    64 rows covers them sooner (16 wanted of 7,200 rows: 15 of 512)."""
    s, chunk = tfdb._split(m, k, n)
    assert s == want and chunk % 64 == 0 and s * chunk >= m > (s - 1) * chunk


@pytest.mark.parametrize("case", ["a_int", "w_f32", "no_chain", "aux_shape", "gelu_no_aux",
                                  "save_f32"])
def test_nt_plan_raises_on_what_the_kernel_does_not_take(case):
    rng = np.random.default_rng(4)
    a, w = _r(rng, 6, 8), _r(rng, 5, 8, dtype=torch.bfloat16)
    aux16 = torch.zeros(6, 5, dtype=torch.bfloat16)
    kw = {"a_int": dict(a=a.to(torch.int32)), "w_f32": dict(w=w.float()),
          "no_chain": dict(w=w[:, :4].contiguous()),
          "aux_shape": dict(aux=torch.zeros(6, 4, dtype=torch.bfloat16)),
          "gelu_no_aux": dict(gelu_save=aux16),
          "save_f32": dict(aux=aux16, save=torch.zeros(6, 5))}[case]
    args = dict(a=a, w=w, aux=None, save=None, gelu_save=None)
    args.update(kw)
    with pytest.raises(ValueError):
        tfdb.nt_plan("t", args["a"], args["w"], args["aux"], args["save"], args["gelu_save"])


@pytest.mark.parametrize("aux_dtype", [torch.bfloat16, torch.float32])
def test_gemm_nt_plain_writes_da1_and_gelu_of_a1(aux_dtype):
    """The GELU-derivative product's side outputs: bf16 of its f32 output
    (da1, the next products' operand) and bf16(gelu(a1)) (dW2's A)."""
    rng = np.random.default_rng(5)
    a, w, a1 = _r(rng, 12, 16), _r(rng, 10, 16, dtype=torch.bfloat16), _r(rng, 12, 10)
    a1 = a1.to(aux_dtype)
    save, gelu_save = (torch.empty(12, 10, dtype=torch.bfloat16) for _ in range(2))
    out = tfdb.gemm_nt_plain(a, w, a1, save=save, gelu_save=gelu_save)
    assert torch.equal(out, tfdb.gemm_nt_plain(a, w, a1))
    assert torch.equal(save, out.to(torch.bfloat16))
    gelu = torch.nn.functional.gelu(a1.float(), approximate="tanh")
    assert torch.equal(gelu_save, gelu.to(torch.bfloat16))
    # dW2 from the saved gelu(a1) is the plain weight gradient through gelu
    dy = _r(rng, 12, 7)
    for got, want in zip(tfdb.weight_grad_plain(gelu_save, dy),
                         tfdb.weight_grad_plain(a1, dy, gelu=True)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m,k,n", [(8640, 480, 1440), (100, 13, 21), (64, 8, 8)])
def test_tn_plan_casts_pads_and_splits(m, k, n):
    rng = np.random.default_rng(m + n)
    a, b = _r(rng, m, k), _r(rng, m, n)
    a16, b16, s, chunk = tfdb.tn_plan("t", a, b)
    k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
    assert tuple(a16.shape) == (m, k8) and tuple(b16.shape) == (m, n8)
    assert torch.equal(a16[:, :k], a.to(torch.bfloat16)) and not a16[:, k:].any()
    assert torch.equal(b16[:, :n], b.to(torch.bfloat16)) and not b16[:, n:].any()
    assert (s, chunk) == tfdb._split(m, k, n)
    given = b.to(torch.bfloat16)
    assert torch.equal(tfdb.tn_plan("t", a, b, given)[1][:, :n], given)
    torch.testing.assert_close(a16.float().t() @ b16.float(),
                               torch.nn.functional.pad(tfdb.weight_grad_plain(a, b)[0],
                                                       (0, n8 - n, 0, k8 - k)),
                               atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("case", ["gelu", "b_bf16", "rows", "b16_shape", "a_int"])
def test_tn_plan_raises_on_what_the_kernel_does_not_take(case):
    rng = np.random.default_rng(6)
    a, b = _r(rng, 20, 8), _r(rng, 20, 16)
    kw = dict(a=a, b=b, b16=None, gelu=False)
    kw.update({"gelu": dict(gelu=True), "b_bf16": dict(b=b.to(torch.bfloat16)),
               "rows": dict(b=b[:10].contiguous()),
               "b16_shape": dict(b16=torch.zeros(20, 8, dtype=torch.bfloat16)),
               "a_int": dict(a=a.to(torch.int32))}[case])
    with pytest.raises(ValueError, match="gelu_save" if case == "gelu" else None):
        tfdb.tn_plan("t", kw["a"], kw["b"], kw["b16"], kw["gelu"])


def test_split_fills_the_card_at_the_ds2_shapes():
    """The split of 8,640 rows for the four (K, N) of a ds2 block: chunks of
    whole 64-row steps covering every row once, each chunk non-empty, and
    for the 12-tile (480, 480) output one unit per SM (11 chunks of 832)."""
    for k, n in ((1920, 480), (480, 1920), (480, 480), (480, 1440)):
        s, chunk = tfdb._split(8640, k, n)
        assert chunk % 64 == 0 and 1 <= s <= 16 and s * chunk >= 8640 > (s - 1) * chunk
    assert tfdb._split(8640, 480, 480) == (11, 832)
    assert tfdb._split(1, 8, 8) == (1, 64)


def test_column_parts_cover_each_chunk_once():
    for length, k in ((832, 480), (100, 1920), (5, 480), (64, 128)):
        parts = tfdb.column_parts(range(1000, 1000 + length), k)
        assert len(parts) == -(-k // 128)
        assert [r for p in parts for r in p] == list(range(1000, 1000 + length))


def test_weight_grad_bias_is_the_sum_of_the_f32_dy():
    """The bias gradient sums dY in f32, not its bf16 copy: values that
    bf16 rounds away stay in it."""
    m, k, n = 300, 8, 16
    a = torch.ones(m, k)
    b = torch.full((m, n), 1.0 + 2.0 ** -12)  # bf16 rounds it to 1.0
    ws, cs = tfdb.weight_grad_partial_plain(a, b)
    s, _ = tfdb._split(m, k, n)
    assert ws.shape == (s, k, n) and cs.shape == (s * tfdb._cdiv(k, 128), n)
    dw, db = tfdb.wgrad_reduce_plain(ws, cs)
    torch.testing.assert_close(db, b.sum(0), rtol=1e-6, atol=0)
    assert (db - b.to(torch.bfloat16).float().sum(0)).abs().min() > 0.05
    torch.testing.assert_close(dw, torch.full((k, n), float(m)))  # the product rounds b


# ---------------------------------------------------------------------------
# the smoke's records of the new kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel,want", [("vit_attention", "vit_attn_wgmma_kernel"),
                                         ("vit_gemm_nt", "nt_wgmma_kernel"),
                                         ("vit_gemm_tn", "tn_wgmma_kernel")])
def test_smoke_names_the_wgmma_kernels(kernel, want):
    smoke = _chip_smoke()
    source, replaces = smoke.REPLACES[kernel]
    assert want in source
    header = ROOT / source.split(":")[0].split()[0]
    assert header.exists() and f"{want}(" in header.read_text()
    assert replaces.startswith("vit4hep_tpu/ops/fused_dit_block.py:")
    assert smoke.TOL[kernel] == (8e-3 if kernel == "vit_attention" else 1e-3)


# kernel names as torch.profiler gives them, and the group each belongs to
CFM_NAMES = {
    "void vattn::vit_attn_wgmma_kernel<80, 3, false>(float const*, unsigned char const*, "
    "__nv_bfloat16*, int, int, int, float)": "K2v attention",
    "void vattn::vit_attn_wgmma_kernel<128, 2, true>(float const*, unsigned char const*, "
    "__nv_bfloat16*, int, int, int, float)": "K2v attention",
    "void (anonymous namespace)::gemm_wgmma_kernel<160, 2>(CUtensorMap_st, CUtensorMap_st, "
    "(anonymous namespace)::GemmArgs)": "K2v gemm_wgmma_kernel",
    "void attn::fwd_kernel<80, false>(float const*, unsigned char const*, float*, float*, int, "
    "int, int, float)": None,
}
FUSED_NAMES = {
    "void kbw::nt_wgmma_kernel<1>(CUtensorMap_st, CUtensorMap_st, kbw::Args)": "K5b gemm_nt",
    "void kbw::nt_wgmma_kernel<0>(CUtensorMap_st, CUtensorMap_st, kbw::Args)": "K5b gemm_nt",
    "kbw::tn_wgmma_kernel(CUtensorMap_st, CUtensorMap_st, kbw::Args)": "K5b gemm_tn",
    "void (anonymous namespace)::gemm_wgmma_kernel<160, 3>(CUtensorMap_st, CUtensorMap_st, "
    "(anonymous namespace)::GemmArgs)": "K5a gemm_wgmma_kernel",
    "void (anonymous namespace)::wgrad_reduce_kernel(float const*, float const*, float*, "
    "float*, int, int, long long, int)": "K5b reductions",
}


@pytest.mark.parametrize("name", list(CFM_NAMES))
def test_smoke_cfm_groups_claim_k2v_attention(name):
    smoke = _chip_smoke()
    claims = [label for label, claims in smoke.CFM_GROUPS if claims(name)]
    assert (claims[0] if claims else None) == CFM_NAMES[name], claims


@pytest.mark.parametrize("name", list(FUSED_NAMES))
def test_smoke_fused_groups_claim_k5b_products(name):
    smoke = _chip_smoke()
    claims = [label for label, claims in smoke.FUSED_TRAIN_GROUPS if claims(name)]
    assert claims and claims[0] == FUSED_NAMES[name], claims


# ---------------------------------------------------------------------------
# head dims past the kernels' 128: not ported yet
# ---------------------------------------------------------------------------
def test_head_dim_160_raises_not_implemented_at_the_panel_check():
    """hidden 480 in 3 heads of 160, which JAX runs: the panel kernels'
    argument check (K1, K2v, K6) names the roadmap item."""
    qkv = torch.zeros(2, 10, 3 * 480)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tfqa.check_kernel_args("qkv_attention_fwd", qkv, 3)
    assert tfqa.check_kernel_args("qkv_attention_fwd", qkv, 6) == (2, 10, 80)


def test_head_dim_160_raises_not_implemented_at_the_qkv_check():
    """The same at the separated q, k, v kernels' check (K8, K7)."""
    q = torch.zeros(2, 3, 10, 160)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tvmem.kernel_qkv_args("vmem_attention_fwd", q, q, q, None)


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, 'PyTorch port')")
    return torch.device("cuda")


def _close(got, want, tol, what):
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    assert err <= tol * scale, f"{what}: max abs error {err:.3e} > {tol} x {scale:.3g}"


ATTN_SHAPES = [(2, 1, 2, 80), (3, 63, 2, 80), (2, 65, 3, 16), (2, 130, 2, 128), (4, 135, 6, 80),
               (2, 200, 2, 33), (2, 450, 6, 80), (3, 70, 2, 13), (1, 193, 1, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,d", ATTN_SHAPES)
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_k2v_attention_kernel_matches_plain_on_cuda(cuda_device, b, n, h, d, kind):
    gen = torch.Generator(device=cuda_device).manual_seed(70 + n + d)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=cuda_device)
    mask = _mask(kind, n)
    mask = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    count = tfdb.ATTENTION.launches
    ctx = tfdb.attention(qkv, h, d ** -0.5, mask)
    torch.cuda.synchronize()
    assert tfdb.ATTENTION.launches - count == 1 and ctx.dtype == torch.bfloat16
    _close(ctx, tfdb.attention_plain(qkv, h, d ** -0.5, mask, torch.bfloat16), 8e-3, "context")
    if kind == "dead_row":
        v = qkv[:, :, 2 * h * d:].mean(1)
        _close(ctx[:, n - 1], v, 8e-3, "the dead row's mean of V")


NT_SHAPES = [(8640, 480, 1920), (8640, 1920, 480), (1000, 1440, 480), (333, 13, 21),
             (65, 200, 97)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", NT_SHAPES)
@pytest.mark.parametrize("aux", [None, torch.bfloat16, torch.float32], ids=["none", "a1-bf16",
                                                                            "a1-f32"])
def test_gemm_nt_kernel_matches_plain_on_cuda(cuda_device, m, k, n, aux):
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    r = lambda *s: torch.randn(*s, generator=gen, device=cuda_device)  # noqa: E731
    a, w = r(m, k).to(torch.bfloat16), (r(n, k) * 0.05).to(torch.bfloat16)
    a1 = None if aux is None else r(m, n).to(aux)
    saves = None if aux is None else [torch.empty(m, n, dtype=torch.bfloat16, device=cuda_device)
                                      for _ in range(2)]
    kw = {} if aux is None else dict(save=saves[0], gelu_save=saves[1])
    count = tfdb.GEMM_NT.launches
    out = tfdb.gemm_nt(a, w, a1, **kw)
    torch.cuda.synchronize()
    assert tfdb.GEMM_NT.launches - count == 1
    want = tfdb.gemm_nt_plain(a, w, a1)
    _close(out, want, 1e-3, "out")
    if aux is not None:  # the f32 output rounded once; gelu(a1) in f32 rounded once
        assert torch.equal(saves[0], out.to(torch.bfloat16))
        assert _bf16_ulps(saves[1], tfdb._gelu(a1.float()), GELU_ATOL) <= 1.0
    _close(tfdb.gemm_nt(a.float(), w), tfdb.gemm_nt_plain(a, w), 1e-3, "f32 A cast once")


TN_SHAPES = [(8640, 1920, 480), (8640, 480, 1440), (8640, 480, 480), (1001, 13, 21),
             (130, 200, 97), (64, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", TN_SHAPES)
def test_weight_grad_kernel_matches_plain_on_cuda(cuda_device, m, k, n):
    gen = torch.Generator(device=cuda_device).manual_seed(m + 2 * k + n)
    a = torch.randn(m, k, generator=gen, device=cuda_device).to(torch.bfloat16)
    b = torch.randn(m, n, generator=gen, device=cuda_device)
    counts = (tfdb.GEMM_TN.launches, tfdb.WGRAD_REDUCE.launches)
    ws, cs = tfdb.weight_grad_partial(a, b)
    torch.cuda.synchronize()
    ws_p, cs_p = tfdb.weight_grad_partial_plain(a, b)
    _close(ws, ws_p, 1e-3, "ws")
    _close(cs, cs_p, 1e-3, "cs")
    dw, db = tfdb.weight_grad(a, b, b16=b.to(torch.bfloat16))
    assert (tfdb.GEMM_TN.launches - counts[0], tfdb.WGRAD_REDUCE.launches - counts[1]) == (2, 1)
    for got, want, what in zip((dw, db), tfdb.weight_grad_plain(a, b), ("dW", "db")):
        _close(got, want, 1e-3, what)
    again = tfdb.weight_grad(a, b)  # no atomics: the same bits
    torch.cuda.synchronize()
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])
    with pytest.raises(ValueError, match="gelu_save"):
        tfdb.weight_grad(a, b, gelu=True)

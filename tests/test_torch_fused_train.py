"""Port parity of the DiT megakernel training tier (K2b, K5a, K5b, K5c and
``fused_vit_forward``'s gradients) against the JAX package.

CPU tests run at the tiny shapes of the JAX package's own residual tests
(tests/test_attention.py: 2 heads x 8, F 32, N 40, B 2, depth 2; inputs
from a numpy seed), unmasked and with the layer-causal mask of the (5, 4, 2)
token grid. The JAX Pallas kernels run in interpret mode (f32), as the JAX
package's tests run them here, and each JAX result is computed once per
module. The port's CPU path is its plain versions, also f32. Tolerances:
atol 2e-5, rtol 1e-5 for forwards and single-block gradients (f32 on both
sides, summation order only); the whole-ViT gradients atol 2e-3, rtol 1e-4,
the bound the JAX package's own residual tests hold its tiers to
(tests/test_attention.py:800), since the gradients of two depth-2 ViTs in
f32 differ by summation order through 2 blocks and the final layer.

CUDA tests (marker ``cuda``) hold each new kernel against its plain
version on the card; they skip without one. On the card (no JAX there):
``python -m pytest --noconftest -m cuda tests/test_torch_fused_train.py``.
"""

import numpy as np
import pytest
import torch

try:  # the JAX reference; the card's machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    from vit4hep_tpu.ops import fused_dit_block as jfdb
except ModuleNotFoundError:
    jax = None

from vit4hep_tpu_torch.ops import fused_dit_block as tfdb
from vit4hep_tpu_torch.ops.pos_embed import layer_causal_mask

HEADS, D, FDIM, N, B, DEPTH, PDIM, ODIM = 2, 8, 32, 40, 2, 2, 6, 12
HID = HEADS * D
SCALE = D ** -0.5
MASK = layer_causal_mask((5, 4, 2))  # 40 tokens
ATOL, RTOL = 2e-5, 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-3, 1e-4
_JAX = {}  # each JAX interpret-mode result, computed once per module


def _once(key, fn):
    if key not in _JAX:
        _JAX[key] = jax.tree.map(np.asarray, fn())
    return _JAX[key]


def _vit_args(seed=7):
    """tokens, pos, mods, fmod, wemb, bemb, 8 block weights (stacked),
    wfin, bfin: the JAX residual tests' draws."""
    rng = np.random.default_rng(seed)
    w = lambda *s, sc=0.1: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    return [w(B, N, PDIM, sc=1.0), w(N, HID, sc=1.0), w(B, DEPTH, 6, HID, sc=0.3),
            w(B, 2, HID, sc=0.3), w(PDIM, HID), w(HID),
            w(DEPTH, HID, 3 * HID), w(DEPTH, 3 * HID), w(DEPTH, HID, HID), w(DEPTH, HID),
            w(DEPTH, HID, FDIM), w(DEPTH, FDIM), w(DEPTH, FDIM, HID), w(DEPTH, HID),
            w(HID, ODIM), w(ODIM)]


def _block_args(seed=11):
    """x, mod6, the 8 weights of one block, and an upstream gradient g."""
    rng = np.random.default_rng(seed)
    a = _vit_args(seed)
    x = rng.normal(size=(B, N, HID)).astype(np.float32)
    g = rng.normal(size=(B, N, HID)).astype(np.float32)
    return x, a[2][:, 0], [t[0] for t in a[6:14]], g


def _mask(masked, torch_=False):
    if not masked:
        return None
    return torch.from_numpy(MASK) if torch_ else jnp.asarray(MASK)


def _t(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _close(port, ref, atol=ATOL, rtol=RTOL, what=""):
    for i, (p, r) in enumerate(zip(port, ref, strict=True)):
        if r is None:
            assert p is None, f"{what} {i}"
            continue
        p = p.detach().numpy() if isinstance(p, torch.Tensor) else p
        np.testing.assert_allclose(p, np.asarray(r), atol=atol, rtol=rtol, err_msg=f"{what} {i}")


def _force_tier(monkeypatch, module, tier):
    """Force a residual tier by pricing the others out, as the JAX
    package's residual tests do: "a1" (as computed), "no_a1", "recompute"."""
    orig = module.train_residual_bytes
    if tier == "no_a1":
        monkeypatch.setattr(module, "train_residual_bytes",
                            lambda n, h, f, d, rb, save_a1=True:
                            (1 << 40) if save_a1 else orig(n, h, f, d, rb, save_a1))
    elif tier == "recompute":
        monkeypatch.setattr(module, "train_residual_bytes", lambda *a, **k: 1 << 40)


# ---------------------------------------------------------------------------
# the tier gate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,pdim", [(135, 48), (450, 90), (N, PDIM)], ids=["ds2", "ds3", "tiny"])
def test_residual_tier_matches_jax(n, pdim):
    """The port's gate picks JAX's tier: at full width in bf16 ds2 saves a1
    (8,812,800 B per element), ds3 does not (19,008,000 B)."""
    for hdim, fdim, depth, heads, out in ((480, 1920, 6, 6, pdim), (HID, FDIM, DEPTH, HEADS, 12)):
        assert tfdb.stack_vmem_estimate(n, hdim, fdim, depth, heads) == \
            jfdb.stack_vmem_estimate(n, hdim, fdim, depth, heads)
        base = (jfdb.stack_vmem_estimate(n, hdim, fdim, depth, heads, 1)
                + 2 * (pdim * hdim + hdim * out) + 4 * n * (hdim + pdim + out))
        for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
            assert tfdb.vit_residual_tier(n, pdim, hdim, fdim, out, depth, heads, tdt) == \
                jfdb._fit_residuals(base, n, hdim, fdim, depth, jdt)
    assert tfdb.vit_residual_tier(135, 48, 480, 1920, 48, 6, 6, torch.bfloat16) == (True, 8812800)
    assert tfdb.vit_residual_tier(450, 90, 480, 1920, 90, 6, 6, torch.bfloat16) == \
        (False, 19008000)
    for g in range(1, 12):
        assert tfdb.safe_group(g, n) == jfdb._safe_group(g, n)


# ---------------------------------------------------------------------------
# single blocks: K2b, K5b, K5c
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "causal"])
def test_block_forward_and_vjp_match_jax(masked):
    """K2b's forward and its VJP (K5c through the autograd.Function)
    against JAX ``fused_dit_block`` and ``fused_dit_block_bwd`` (interpret);
    the port's K5c called directly agrees as well."""
    x, mod6, ws, g = _block_args()
    mask = _mask(masked)
    ref = _once(("block_fwd", masked), lambda: jfdb.fused_dit_block(
        x, mod6, *ws, mask, HEADS, SCALE))
    ref_bwd = _once(("block_bwd", masked), lambda: jfdb.fused_dit_block_bwd(
        x, mod6, *ws, g, mask, HEADS, SCALE))
    tmask = _mask(masked, torch_=True)
    ins = [t.requires_grad_() for t in _t([x, mod6, *ws])]
    out = tfdb.fused_dit_block(*ins, tmask, HEADS, SCALE)
    _close([out], [ref], what="K2b forward")
    out.backward(torch.from_numpy(g))
    _close([t.grad for t in ins], ref_bwd, what="K2b VJP")
    direct = tfdb.fused_dit_block_bwd(*_t([x, mod6, *ws, g]), tmask, HEADS, SCALE)
    _close(direct, ref_bwd, what="K5c")
    with torch.no_grad():
        _close([tfdb.fused_dit_block(*_t([x, mod6, *ws]), tmask, HEADS, None)], [ref],
               what="K2b no-grad")


@pytest.mark.parametrize("have_a1", [True, False], ids=["a1", "no-a1"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "causal"])
def test_block_bwd_res_matches_jax(have_a1, masked):
    """K5b from saved residuals against JAX ``fused_dit_block_bwd_res``
    (interpret) and ``_block_bwd_res_xla``, with and without a1; the
    residuals themselves against JAX ``_block_body(want_res=True)``."""
    x, mod6, ws, g = _block_args(13)
    wqkv, bqkv, wout, bout, w1, b1, w2, b2 = ws
    tmask = _mask(masked, torch_=True)
    _, qkv, ctx, a1, y = (t.numpy() for t in tfdb.block_fwd_res_plain(
        *_t([x, mod6, *ws]), tmask, HEADS, SCALE))
    mask = _mask(masked)
    body = [jfdb._block_body(x[i], mod6[i], *ws, None if mask is None else mask,
                             num_heads=HEADS, head_dim=D, scale=SCALE, mm_dtype=jnp.float32,
                             want_res=True)[1] for i in range(B)]
    _close([qkv, ctx, a1, y], [np.stack(r) for r in zip(*body)], what="residuals")
    a1 = a1 if have_a1 else None
    args = (x, qkv, ctx, a1, y, mod6, wqkv, wout, bout, w1, b1, w2, g)
    ref = _once(("bwd_res", have_a1, masked), lambda: jfdb.fused_dit_block_bwd_res(
        *args, mask, HEADS, SCALE))
    ref_xla = _once(("bwd_res_xla", have_a1, masked), lambda: jfdb._block_bwd_res_xla(
        *args, mask, HEADS, SCALE))
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    port = tfdb.fused_dit_block_bwd_res(*targs, tmask, HEADS, SCALE)
    _close(port, ref, what="K5b vs kernel")
    _close(port, ref_xla, what="K5b vs xla")
    _close(tfdb.block_bwd_res_plain(*targs, tmask, HEADS, SCALE), ref_xla, what="hybrid arm")


# ---------------------------------------------------------------------------
# the whole ViT: K5a and fused_vit_forward's gradients on every tier
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "causal"])
def test_vit_fwd_train_matches_jax(masked):
    """K5a's output and residual set against JAX ``_vit_fwd_train``."""
    args = _vit_args()
    mask = _mask(masked)
    out, (_, saved) = _once(("vit_fwd_train", masked), lambda: jfdb._vit_fwd_train(
        *args, mask, HEADS, SCALE, 1))
    port, res, lses = tfdb.vit_fwd_train(*_t(args), _mask(masked, torch_=True), HEADS, SCALE)
    _close([port, *res], [out, *saved], what="K5a")
    assert res[0].shape == (B, DEPTH + 1, N, HID) and lses.shape == (B, DEPTH, HEADS, N)


TIERS = [("a1", "pallas", False), ("a1", "xla", False), ("no_a1", "pallas", False),
         ("no_a1", "xla", False), ("recompute", "pallas", False), ("a1", "pallas", True),
         ("no_a1", "xla", True), ("recompute", "pallas", True)]


@pytest.mark.parametrize("tier,bwd,masked", TIERS,
                         ids=[f"{t}-{b}-{'causal' if m else 'unmasked'}" for t, b, m in TIERS])
def test_fused_vit_grads_match_jax(monkeypatch, tier, bwd, masked):
    """jax.grad of JAX ``fused_vit_forward`` against the port's autograd on
    the same tier (forced in both packages) and ``bwd`` arm, for every
    input; the forward is K5a (tiers a1, no_a1) or K2v (recompute)."""
    args = _vit_args()
    mask = _mask(masked)

    def jax_grads():
        _force_tier(monkeypatch, jfdb, tier)
        saved = jfdb._vit_fwd_train(*args, mask, HEADS, SCALE, 1)[1][1]
        assert (saved is None) == (tier == "recompute")
        assert tier == "recompute" or (saved[3] is None) == (tier == "no_a1")
        return jax.grad(lambda *a: jnp.sum(jfdb.fused_vit_forward(
            *a, mask, HEADS, SCALE, 1, bwd) ** 2), argnums=tuple(range(16)))(*args)

    ref = _once(("vit_grads", tier, bwd, masked), jax_grads)
    _force_tier(monkeypatch, tfdb, tier)
    ins = [t.requires_grad_() for t in _t(args)]
    out = tfdb.fused_vit_forward(*ins, _mask(masked, torch_=True), HEADS, SCALE, 1, bwd)
    (out ** 2).sum().backward()
    _close([t.grad for t in ins], ref, atol=GRAD_ATOL, rtol=GRAD_RTOL, what=f"{tier} {bwd}")


def test_fused_vit_forward_refuses_an_unknown_arm():
    with pytest.raises(ValueError, match="bwd"):
        tfdb.fused_vit_forward(*_t(_vit_args()), None, HEADS, SCALE, 1, "nope")


# ---------------------------------------------------------------------------
# the plain versions of the new kernels, against their definitions
# ---------------------------------------------------------------------------
def test_backward_kernel_plain_versions_compose_to_k5b():
    """gemm_nt, weight_grad, bwd_rows and dmod_reduce's plain versions,
    chained as K5b's kernels are on the card, give block_bwd_res_plain on
    bf16 multiplicands (the card's arithmetic; the attention through K1's
    plain backward): the split of the computation into kernels is the
    function it replaces."""
    x, mod6, ws, g = (torch.from_numpy(a) if isinstance(a, np.ndarray) else _t(a)
                      for a in _block_args(17))
    wqkv, bqkv, wout, bout, w1, b1, w2, b2 = ws
    bf = torch.bfloat16
    _, qkv, ctx, a1, y, lse = tfdb.block_fwd_res_plain(x, mod6, *ws, None, HEADS, SCALE, bf,
                                                       want_lse=True)
    a1, y = a1.to(bf), y.to(bf)  # the types K5a saves them in
    attn = tfdb.linear_plain(ctx.reshape(-1, HID), wout, bout, tfdb.EPI_BIAS).view(B, N, HID)
    (h, h2, dy), s1 = tfdb.bwd_rows_plain(1, x, mod6, attn=attn, g=g, y=y)
    rows = lambda t: t.reshape(B * N, -1)  # noqa: E731
    da1 = tfdb.gemm_nt_plain(rows(dy), w2, aux=rows(a1))
    dw2, db2 = tfdb.weight_grad_plain(rows(a1), rows(dy), gelu=True)
    dh2 = tfdb.gemm_nt_plain(da1, w1)
    dw1, db1 = tfdb.weight_grad_plain(rows(h2), da1)
    (dx1, dattn), s2 = tfdb.bwd_rows_plain(2, x, mod6, attn=attn, g=g, dgrad=dh2.view(B, N, HID))
    dctx = tfdb.gemm_nt_plain(rows(dattn), wout)
    dwout, dbout = tfdb.weight_grad_plain(rows(ctx), rows(dattn))
    from vit4hep_tpu_torch.ops.fused_qkv_attention import attention_bwd_plain

    dqkv = attention_bwd_plain(qkv, dctx.view(B, N, HID), lse, HEADS, SCALE)
    dh = tfdb.gemm_nt_plain(rows(dqkv), wqkv)
    dwqkv, dbqkv = tfdb.weight_grad_plain(rows(h), rows(dqkv))
    (dx,), s3 = tfdb.bwd_rows_plain(3, x, mod6, dgrad=dh.view(B, N, HID), dx1=dx1)
    part = torch.stack([s1, s2, s3], 1)  # three "chunks", each holding its slots
    got = (dx, tfdb.dmod_reduce_plain(part), dwqkv, dbqkv, dwout, dbout, dw1, db1, dw2, db2)
    want = tfdb.block_bwd_res_plain(x, qkv, ctx, a1, y, mod6, wqkv, wout, bout, w1, b1, w2, g,
                                    None, HEADS, SCALE, bf, attn_dtype=torch.float32)
    # the same bf16-rounded multiplicands on both sides (the attention in
    # f32, as K1's backward): f32 summation order only
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max(), i


def test_linear_plain_saves_residuals():
    """The training epilogues: GELU also saving the pre-GELU a1, the gated
    residual out of place also saving y."""
    rng = np.random.default_rng(3)
    a, w, bias, resid, gate = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                               for s in ((6, 8), (8, 5), (5,), (6, 5), (2, 5)))
    y = a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float() + bias
    save = torch.empty(6, 5, dtype=torch.bfloat16)
    hid = tfdb.linear_plain(a, w, bias, tfdb.EPI_BIAS_GELU, save=save)
    torch.testing.assert_close(save, y.to(torch.bfloat16))
    torch.testing.assert_close(hid, torch.nn.functional.gelu(y, approximate="tanh")
                               .to(torch.bfloat16))
    out = torch.empty(6, 5)
    r = tfdb.linear_plain(a, w, bias, tfdb.EPI_GATED_RESID, out=out, resid=resid, gate=gate,
                          n_tok=3, save=save)
    assert r is out
    torch.testing.assert_close(out, resid + gate.repeat_interleave(3, 0) * y)
    torch.testing.assert_close(save, y.to(torch.bfloat16))


def test_split_and_row_chunks_cover_every_row():
    for m in (1, 31, 32, 80, 8640, 7200):
        for k, n in ((480, 480), (480, 1920), (16, 48)):
            s, chunk = tfdb._split(m, k, n)
            assert chunk % 32 == 0 and s * chunk >= m > (s - 1) * chunk
    assert tfdb._split(8640, 480, 480) == (9, 960)
    for n in (1, 40, 135, 450):
        s, rows = tfdb.row_chunks(n)
        assert s * rows >= n > (s - 1) * rows


# ---------------------------------------------------------------------------
# on the card: each new kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, 'PyTorch port')")
    return torch.device("cuda")


def _scaled_close(out, ref, rel):
    """bf16 multiplicands: held relative to the output's own scale."""
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= rel * max(1e-6, ref.float().abs().max().item()), err


def _card_block(device, b=4, n=135, h=480, f=1920, seed=21):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=0.05: (torch.randn(*s, generator=gen) * sc).to(device)  # noqa: E731
    ws = [r(h, 3 * h), r(3 * h), r(h, h), r(h), r(h, f), r(f), r(f, h), r(h)]
    return r(b, n, h, sc=1.0), r(b, 6, h, sc=0.3), ws, r(b, n, h, sc=1.0)


@pytest.mark.cuda
def test_train_kernels_match_plain_on_cuda(cuda_device):
    """The training GEMM epilogues, the NT and split-K TN products, the row
    passes and the adaLN reduction, each with its launch counted."""
    x, mod6, ws, g = _card_block(cuda_device)
    b, n, h = x.shape
    m = b * n
    w1 = ws[4].to(torch.bfloat16)
    hb = torch.randn(m, h, device=cuda_device).to(torch.bfloat16)
    save_k, save_p = (torch.empty(m, 1920, dtype=torch.bfloat16, device=cuda_device)
                      for _ in range(2))
    count = tfdb.TRAIN_GEMM.launches
    hid = tfdb.train_linear(hb, w1, ws[5], tfdb.EPI_BIAS_GELU, save=save_k, n_tok=n)
    assert tfdb.TRAIN_GEMM.launches - count == 1
    _scaled_close(hid, tfdb.linear_plain(hb, w1, ws[5], tfdb.EPI_BIAS_GELU, save=save_p), 8e-3)
    _scaled_close(save_k, save_p, 8e-3)
    dy = torch.randn(m, h, device=cuda_device)
    a1 = save_k
    w2 = ws[6].to(torch.bfloat16)
    _scaled_close(tfdb.gemm_nt(dy, w2, aux=a1), tfdb.gemm_nt_plain(dy, w2, aux=a1), 1e-3)
    _scaled_close(tfdb.gemm_nt(dy, w2), tfdb.gemm_nt_plain(dy, w2), 1e-3)
    for a, gelu in ((a1, True), (hb, False), (dy, False)):
        for got, want in zip(tfdb.weight_grad(a, dy, gelu), tfdb.weight_grad_plain(a, dy, gelu)):
            _scaled_close(got, want, 1e-3)
    attn = torch.randn(b, n, h, device=cuda_device)
    y = torch.randn(b, n, h, device=cuda_device).to(torch.bfloat16)
    s = tfdb.row_chunks(n)[0]
    part = torch.zeros(b, s, 6, h, device=cuda_device)
    outs = tfdb.bwd_rows(1, x, mod6, part, attn=attn, g=g, y=y)
    want, sums = tfdb.bwd_rows_plain(1, x, mod6, attn=attn, g=g, y=y)
    for o, w in zip(outs, want):
        _scaled_close(o, w, 8e-3)
    outs2 = tfdb.bwd_rows(2, x, mod6, part, attn=attn, g=g, dgrad=dy.view(b, n, h))
    want2, sums2 = tfdb.bwd_rows_plain(2, x, mod6, attn=attn, g=g, dgrad=dy.view(b, n, h))
    outs3 = tfdb.bwd_rows(3, x, mod6, part, dgrad=dy.view(b, n, h), dx1=outs2[0])
    want3, sums3 = tfdb.bwd_rows_plain(3, x, mod6, dgrad=dy.view(b, n, h), dx1=outs2[0])
    for o, w in zip(outs2 + outs3, want2 + want3):
        _scaled_close(o, w, 1e-4)
    _scaled_close(tfdb.dmod_reduce(part), sums + sums2 + sums3, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("save_a1,mask_grid", [(True, None), (False, None), (True, (15, 1, 9)),
                                               (False, (15, 1, 9))],
                         ids=["a1", "no-a1", "a1-causal", "no-a1-causal"])
def test_block_bwd_res_kernel_matches_plain_on_cuda(cuda_device, save_a1, mask_grid):
    """K5b at the ds2 widths (batch 4) against the plain residual backward
    on bf16 multiplicands, from residuals of the plain forward."""
    x, mod6, ws, g = _card_block(cuda_device)
    mask = None if mask_grid is None else \
        torch.from_numpy(layer_causal_mask(mask_grid)).to(cuda_device)
    _, qkv, ctx, a1, y = tfdb.block_fwd_res_plain(x, mod6, *ws, mask, 6, 80 ** -0.5,
                                                  torch.bfloat16)
    a1 = a1.to(torch.bfloat16) if save_a1 else None
    y = y.to(torch.bfloat16)
    wqkv, _, wout, bout, w1, b1, w2, _ = ws
    args = (x, qkv, ctx, a1, y, mod6, wqkv, wout, bout, w1, b1, w2, g, mask, 6, 80 ** -0.5)
    counters = (tfdb.GEMM_NT, tfdb.GEMM_TN, tfdb.WGRAD_REDUCE, tfdb.BWD_ROWS, tfdb.DMOD_REDUCE)
    before = [c.launches for c in counters]
    got = tfdb.fused_dit_block_bwd_res(*args)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [4, 4, 4, 3, 1]
    for o, w in zip(got, tfdb.block_bwd_res_plain(*args, mm_dtype=torch.bfloat16,
                                                  attn_dtype=torch.float32)):
        _scaled_close(o, w, 2e-2)


@pytest.mark.cuda
def test_k2b_k5c_k5a_match_plain_on_cuda(cuda_device):
    """K2b's forward, K5c and K5a's output and residuals at the ds2 widths
    (batch 4) against their plain versions."""
    x, mod6, ws, g = _card_block(cuda_device)
    _scaled_close(tfdb.fused_dit_block(x, mod6, *ws, None, 6, None),
                  tfdb.dit_block_reference(x, mod6, *ws, None, 6, 80 ** -0.5), 2e-2)
    for o, w in zip(tfdb.fused_dit_block_bwd(x, mod6, *ws, g, None, 6, None),
                    tfdb.block_bwd_plain(x, mod6, *ws, g, None, 6, 80 ** -0.5, torch.bfloat16,
                                         torch.float32)):
        _scaled_close(o, w, 2e-2)
    gen = torch.Generator().manual_seed(5)
    r = lambda *s, sc=0.05: (torch.randn(*s, generator=gen) * sc).to(cuda_device)  # noqa: E731
    args = [r(4, 135, 48, sc=1.0), r(135, 480, sc=1.0), r(4, 6, 6, 480, sc=0.3),
            r(4, 2, 480, sc=0.3), r(48, 480), r(480), r(6, 480, 1440), r(6, 1440),
            r(6, 480, 480), r(6, 480), r(6, 480, 1920), r(6, 1920), r(6, 1920, 480), r(6, 480),
            r(480, 48), r(48)]
    out, res, lses = tfdb.vit_fwd_train(*args, None, 6, None)
    pout, pres, plses = tfdb.vit_fwd_train_plain(*args, None, 6, 80 ** -0.5,
                                                 mm_dtype=torch.bfloat16)
    for o, w in zip((out, *res, lses), (pout, *pres, plses)):
        _scaled_close(o, w, 2e-2)

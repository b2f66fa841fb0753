"""K7 in split TF32 (``csrc/flash_tf32.cuh``): the pre-pass
``k7_split_kernel`` and the passes ``k7_fwd_kernel``, ``k7_bwd_dkv_kernel``
and ``k7_bwd_dq_kernel`` that read its buffers.

CPU tests:
  - The pre-pass's layouts as index maps: ``split_plain`` (the kernel's
    plain version) read back as wgmma reads a K-major tf32 operand with the
    32-byte swizzle (an 8-row group's core matrix of 8 rows x 32 bytes, the
    two 16-byte halves of a row swapped where (row % 8) / 4 is odd; the rows
    layout's 8-row groups DP x 32 bytes apart, the cols layout's chunks of
    8 rows in the order 0, 2, 4, 6, 1, 3, 5, 7) gives back every element of
    the operand once, zero past N and past d; hi + lo is the value to
    2^-22 of it, both tf32.
  - A torch emulation of the kernels' arithmetic (each product hi hi + hi lo
    + lo hi from the read-back buffers, P and dS split as the registers
    hold them; tf32 by rounding the mantissa as ``cvt.rna.tf32.f32``) held
    to ``chip_smoke.TOL`` = 1e-4 of max(1, max|plain|) against
    ``flash_fwd_plain`` / ``flash_bwd_plain`` at K7's test shapes (N = 50,
    150, 300: tails of the 32-row tiles and the 64-row padding; d = 48 and
    80; unmasked, layer-causal, one wholly masked row): three terms hold
    it, one TF32 product misses it by 10x or more. The same emulation
    against JAX's ``flash_attention`` (its Pallas kernels in interpret
    mode, as tests/test_torch_flash_attention.py runs them), same bound.
  - JAX's dead-row rule in the emulated backward: every masked key's p is
    exactly 0 and the wholly masked row's dQ is exactly 0.
  - The wrappers' ``BwdOps`` against ``k7::BwdOps`` in the header: the same
    fields in the same order, and each pass handed exactly the buffers its
    kernel reads.

CUDA tests (marker ``cuda``; they skip without a card): the pre-pass bit
for bit against ``split_plain`` on strided views; the three passes against
the plain versions (1e-4 of the scale) at the smoke's shapes (13,500
tokens with one element, (64, 6, 450, 80) layer-causal, (8, 6, 300, 80)
with a tail tile and a dead row) and at d = 13-128 on strided views; the
forward against f64 within 2e-5 of the scale at every padded head dim,
unmasked, all-True and layer-causal; each masked forward of K7, K6 and K2v
with an all-True mask equal to its unmasked kernel at every padded head
dim (the register fault of PERF.md section 6: K6's and K2v's masked
forwards at DP = 64 had lost Q's fragments); autograd launching each
counter as expected. On the card (no JAX there):
``python -m pytest --noconftest -m cuda tests/test_torch_k7_tf32.py``.
"""

import ctypes
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

try:  # the JAX reference; the card's machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    import vit4hep_tpu.ops.flash_attention as jfa
except ModuleNotFoundError:
    jax = None

from vit4hep_tpu_torch.ops import flash_attention as tfa
from vit4hep_tpu_torch.ops.pos_embed import layer_causal_mask

ROOT = Path(__file__).resolve().parents[1]
K7_TOL = 1e-4  # chip_smoke.TOL["flash_attn_fwd"], ["flash_attn_bwd_dkv"], ["flash_attn_bwd_dq"]
F64_TOL = 2e-5  # chip_smoke.K7_F64_TOL
MASK_KINDS = ["none", "layer_causal", "dead_row"]
DEAD = 7  # the wholly masked row
PADDED_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, 'PyTorch port')")
    return torch.device("cuda")


def _mask(kind, n):
    """None, the layer-causal mask of an (n / 6, 3, 2) token grid (causal
    where n is not a multiple of 6), or a causal mask whose row DEAD attends
    to no key."""
    if kind == "none":
        return None
    if kind == "layer_causal":
        return layer_causal_mask((n // 6, 3, 2)) if n % 6 == 0 else np.tril(np.ones((n, n), bool))
    mask = np.tril(np.ones((n, n), bool))
    mask[DEAD] = False
    return mask


def _inputs(seed, b, h, n, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(4))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_k7", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# ---------------------------------------------------------------------------
# the pre-pass's layouts as index maps
# ---------------------------------------------------------------------------
def _swizzled(row, slot):
    """Float of K-slot ``slot`` of ``row`` in a core matrix (8 rows x 32
    bytes) as wgmma reads the 32-byte swizzle: the 16-byte half index XORed
    with (row / 4) % 2."""
    return row * 8 + (((slot // 4) ^ ((row // 4) % 2)) * 4) + slot % 4


def _address(layout, row, col, dp):
    """The float of element (row, col) of a cell's buffer: ROWS, row's
    8-row group (DP x 8 floats apart), col's 8-column chunk (one core
    matrix, 64 floats), the K index col % 8; COLS, row's 8-row chunk, col
    as the N index (its 8-row group of core matrices), the K index the
    row's slot in the chunk order."""
    if layout == tfa.ROWS:
        return (row // 8) * dp * 8 + (col // 8) * 64 + _swizzled(row % 8, col % 8)
    slot = tfa.CHUNK_ORDER.index(row % 8)
    return (row // 8) * dp * 8 + (col // 8) * 64 + _swizzled(col % 8, slot)


def _read(buf, layout, n, d):
    """A split buffer (B, H, N_pad, DP) read back as the (B, H, n, d)
    operand wgmma sees."""
    b, h, n_pad, dp = buf.shape
    idx = torch.tensor([[_address(layout, r, c, dp) for c in range(d)] for r in range(n)])
    return buf.reshape(b, h, -1)[:, :, idx.flatten()].reshape(b, h, n, d)


@pytest.mark.parametrize("layout", [tfa.ROWS, tfa.COLS])
@pytest.mark.parametrize("n,d", [(50, 48), (150, 80), (13, 20), (64, 128)])
def test_split_layouts_hold_every_element_once(layout, n, d):
    b, h = 2, 3
    x = (torch.arange(b * h * n * d, dtype=torch.float32) + 1).reshape(b, h, n, d)
    n_pad, dp = tfa.padded(n), tfa.padded_dim(d)
    xp = torch.zeros(b, h, n_pad, dp)
    xp[..., :n, :d] = x
    buf = tfa.layout_plain(xp, layout)
    assert buf.shape == (b, h, n_pad, dp)
    # a permutation of the padded operand: every value once, zeros elsewhere
    assert torch.equal(buf.reshape(b, h, -1).sort(-1).values, xp.reshape(b, h, -1).sort(-1).values)
    # and where wgmma reads each element
    full = torch.tensor([[_address(layout, r, c, dp) for c in range(dp)] for r in range(n_pad)])
    assert torch.equal(buf.reshape(b, h, -1)[:, :, full.flatten()].reshape(b, h, n_pad, dp), xp)
    assert torch.equal(_read(buf, layout, n, d), x)


def test_cols_chunks_hold_their_rows_in_the_register_order():
    """Slot s of a cols chunk holds row CHUNK_ORDER[s], so that a thread's
    accumulator columns 2t, 2t + 1 sit where a tf32 A fragment reads K
    indices t, t + 4."""
    x = torch.arange(16, dtype=torch.float32).reshape(1, 1, 16, 1) + 1  # value = row + 1
    buf = tfa.layout_plain(torch.nn.functional.pad(x, (0, 15, 0, 48)), tfa.COLS).reshape(-1)
    for chunk in range(2):
        row0 = buf[chunk * 16 * 8:chunk * 16 * 8 + 8]  # column 0: its 8 slots (no swap)
        assert row0.tolist() == [8 * chunk + r + 1 for r in tfa.CHUNK_ORDER]
    assert tfa.CHUNK_ORDER == (0, 2, 4, 6, 1, 3, 5, 7)
    for t in range(4):
        assert (tfa.CHUNK_ORDER[t], tfa.CHUNK_ORDER[t + 4]) == (2 * t, 2 * t + 1)


def test_split_plain_is_two_tf32_parts():
    x = torch.from_numpy(_inputs(300, 1, 2, 70, 80)[0])
    for layout in (tfa.ROWS, tfa.COLS):
        hi, lo = (_read(t, layout, 70, 80) for t in tfa.split_plain(x, layout))
        for part in (hi, lo):
            assert not (part.view(torch.int32) & 0x1FFF).any()  # tf32: low 13 bits zero
        assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -21).all()
        assert torch.equal(hi, tfa.tf32_plain(x))


def test_bwd_ops_mirrors_the_kernels_struct():
    """The wrappers' BwdOps has k7::BwdOps's fields in its order, a pointer
    each, and each pass is handed exactly the buffers its kernel reads."""
    src = (ROOT / "vit4hep_tpu_torch/csrc/flash_tf32.cuh").read_text()
    body = re.search(r"struct BwdOps \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"\*(\w+)", re.sub(r"//[^\n]*", "", body))
    assert [name for name, _ in tfa.BwdOps._fields_] == fields
    assert ctypes.sizeof(tfa.BwdOps) == ctypes.sizeof(ctypes.c_void_p) * len(fields)
    for kernel, passes in (("k7_bwd_dq_kernel", ("dq",)), ("k7_bwd_dkv_kernel", ("dkv",))):
        start = src.index(f"{kernel}(BwdOps x")
        reads = set(re.findall(r"\bx\.(\w+)", src[start:src.index("\n}\n", start)]))
        assert reads == {tfa.bwd_field(op, part) for op in tfa._needs(passes)
                         for part in ("hi", "lo")}, kernel


# ---------------------------------------------------------------------------
# split TF32 (CPU emulation of the kernels' arithmetic)
# ---------------------------------------------------------------------------
def _parts(x, layout, terms):
    """(hi, lo) of x as the kernels read it from its buffer (lo zero with
    one term)."""
    n, d = x.shape[-2:]
    hi, lo = (_read(t, layout, n, d) for t in tfa.split_plain(x, layout))
    return hi, lo if terms == 3 else torch.zeros_like(lo)


def _regs(x, terms):
    """(hi, lo) of values split in registers (P, dS, the forward's Q)."""
    hi = tfa.tf32_plain(x)
    return hi, tfa.tf32_plain(x - hi) if terms == 3 else torch.zeros_like(x)


def _mm3(a, b):
    """a b from (hi, lo) pairs: hi hi + hi lo + lo hi, accumulated in f32."""
    (ah, al), (bh, bl) = a, b
    return torch.matmul(ah, bh) + torch.matmul(ah, bl) + torch.matmul(al, bh)


def _t(pair):
    return tuple(x.transpose(-1, -2) for x in pair)


def _tf32_fwd(q, k, v, scale, mask, terms):
    """k7_fwd_kernel's function: Q split in the CTA, K (rows) and V^T
    (cols) from the pre-pass, P split as the registers hold it; a masked
    score -1e30."""
    s = _mm3(_regs(q, terms), _t(_parts(k, tfa.ROWS, terms))) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)  # noqa: E741
    return _mm3(_regs(p, terms), _parts(v, tfa.COLS, terms)) / l, (m + torch.log(l))[..., 0]


def _tf32_bwd(q, k, v, g, out, lse, scale, mask, terms):
    """k7_bwd_dkv_kernel's and k7_bwd_dq_kernel's function with JAX's
    masked-key rule: p = exp(where(mask, s scale, -inf) - lse), delta =
    rowsum(dO * O); returns (dq, dk, dv, p)."""
    delta = tfa.delta_plain(g, out)[..., None]
    qr, gr, kr, vr = (_parts(x, tfa.ROWS, terms) for x in (q, g, k, v))
    # the dK/dV pass: S^T = K Q^T, dP^T = V dO^T; dV += P^T dO, dK += dS^T Q
    st = _mm3(kr, _t(qr)) * scale
    if mask is not None:
        st = torch.where(mask.T, st, torch.full_like(st, -float("inf")))
    pt = torch.exp(st - lse[..., None, :])
    dst = pt * (_mm3(vr, _t(gr)) - delta.transpose(-1, -2)) * scale
    dv = _mm3(_regs(pt, terms), _parts(g, tfa.COLS, terms))
    dk = _mm3(_regs(dst, terms), _parts(q, tfa.COLS, terms))
    # the dQ pass: S = Q K^T, dP = dO V^T; dQ += dS K
    s = _mm3(qr, _t(kr)) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, -float("inf")))
    p = torch.exp(s - lse[..., None])
    ds = p * (_mm3(gr, _t(vr)) - delta) * scale
    dq = _mm3(_regs(ds, terms), _parts(k, tfa.COLS, terms))
    return dq, dk, dv, p


def _rel(got, want):
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


@pytest.mark.parametrize("n,d", [(50, 48), (150, 80), (300, 80), (300, 48)])
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_split_tf32_holds_the_f32_contract(n, d, kind):
    q, k, v, g = map(torch.from_numpy, _inputs(310 + n + d, 2, 2, n, d))
    mask = _mask(kind, n)
    mask = None if mask is None else torch.from_numpy(mask)
    scale = d ** -0.5
    out, lse = tfa.flash_fwd_plain(q, k, v, scale, mask)
    want = tfa.flash_bwd_plain(q, k, v, g, out, lse, scale, mask)
    results = {}
    for terms in (3, 1):
        o, ls = _tf32_fwd(q, k, v, scale, mask, terms)
        results[terms] = (o, ls, *_tf32_bwd(q, k, v, g, out, lse, scale, mask, terms)[:3])
    for i, ref in enumerate((out, lse, *want)):
        err3, err1 = _rel(results[3][i], ref), _rel(results[1][i], ref)
        assert err3 <= K7_TOL, (i, err3)
        if i != 1:  # the lse: a sum of exponentials, one product's error averaged out
            assert err3 * 10 <= err1, (i, err3, err1)


@pytest.mark.skipif(jax is None, reason="needs JAX (the reference)")
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_split_tf32_matches_jax(kind):
    b, h, n, d = 2, 2, 150, 80
    q, k, v, g = _inputs(320, b, h, n, d)
    mask = _mask(kind, n)
    jmask = None if mask is None else jnp.asarray(mask)
    out_j, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a, jmask, 128, 128),
                         *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(g))
    tmask = None if mask is None else torch.from_numpy(mask)
    qt, kt, vt, gt = map(torch.from_numpy, (q, k, v, g))
    scale = d ** -0.5
    out, lse = _tf32_fwd(qt, kt, vt, scale, tmask, 3)
    assert _rel(out, torch.from_numpy(np.array(out_j))) <= K7_TOL
    grads = _tf32_bwd(qt, kt, vt, gt, out, lse, scale, tmask, 3)[:3]
    for name, got, want in zip("qkv", grads, grads_j):
        assert _rel(got, torch.from_numpy(np.array(want))) <= K7_TOL, name


def test_emulated_backward_keeps_jax_dead_row_rule():
    """A masked key weighs exactly 0 (p = exp(-inf - lse)), so the wholly
    masked row's dQ is exactly 0 and it adds nothing to dK and dV, unlike
    K1's rule (p = 1 for each of its keys)."""
    n, d = 150, 48
    q, k, v, g = map(torch.from_numpy, _inputs(330, 1, 2, n, d))
    mask = torch.from_numpy(_mask("dead_row", n))
    scale = d ** -0.5
    out, lse = tfa.flash_fwd_plain(q, k, v, scale, mask)
    assert torch.all(lse[:, :, DEAD] == -1e30)
    dq, dk, dv, p = _tf32_bwd(q, k, v, g, out, lse, scale, mask, 3)
    assert torch.all(p[..., ~mask] == 0)
    assert torch.all(dq[:, :, DEAD] == 0)
    # the dead row's output does not reach dK and dV: the same with its
    # upstream gradient zeroed
    g0 = g.clone()
    g0[:, :, DEAD] = 0
    _, dk0, dv0, _ = _tf32_bwd(q, k, v, g0, out, lse, scale, mask, 3)
    torch.testing.assert_close(dk, dk0, rtol=0, atol=1e-6)
    torch.testing.assert_close(dv, dv0, rtol=0, atol=1e-6)


def test_smoke_names_the_new_kernels_and_keeps_the_bounds():
    smoke = _chip_smoke()
    assert smoke.TOL["flash_attn_fwd"] == smoke.TOL["flash_attn_bwd_dkv"] == \
        smoke.TOL["flash_attn_bwd_dq"] == K7_TOL
    assert smoke.TOL["flash_attn_split"] == 0.0 and smoke.K7_F64_TOL == F64_TOL
    for kernel, want in (("flash_attn_split", "k7_split_kernel"),
                         ("flash_attn_fwd", "k7_fwd_kernel"),
                         ("flash_attn_bwd_dkv", "k7_bwd_dkv_kernel"),
                         ("flash_attn_bwd_dq", "k7_bwd_dq_kernel")):
        source, replaces = smoke.REPLACES[kernel]
        path = ROOT / source.split()[0].rstrip(":")
        assert want in source and path.name == "flash_tf32.cuh"
        assert f"{want}(" in path.read_text()
        assert replaces.startswith("vit4hep_tpu/ops/flash_attention.py:")
        assert smoke.OPT_IN[kernel].name == kernel
    # the profile groups claim every K7 kernel, the pre-pass included
    def group(name):
        return next(label for label, claims in smoke.DS3_TRAIN_GROUPS
                    if claims(f"void k7::{name}(...)"))

    assert [group(name) for name in ("k7_split_kernel<80>", "k7_fwd_kernel<80, false>",
                                     "k7_bwd_dkv_kernel<80, true>",
                                     "k7_bwd_dq_kernel<80, false>")] == \
        ["K7 pre-pass", "K7 forward", "K7 backward", "K7 backward"]
    assert smoke.DS3_LONG_PER_EVAL == {"energy_decoder": 1, "flash_attn_split": 6,
                                       "flash_attn_fwd": 6}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _cuda_case(device, b, h, n, d, kind, seed=0):
    """q, k, v strided views of a qkv panel, dO a strided view, the mask."""
    gen = torch.Generator(device=device).manual_seed(seed + 400 + n + d)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=device)
    q, k, v = qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    g = torch.randn(b, n, h * d, generator=gen, device=device).reshape(b, n, h, d) \
        .permute(0, 2, 1, 3)
    mask = _mask(kind, n)
    return q, k, v, g, None if mask is None else torch.from_numpy(mask).to(device)


def _hold(got, ref, tol=K7_TOL):
    scale = max(1.0, ref.abs().max().item())
    err = (got.double() - ref.double()).abs().max().item()
    assert err <= tol * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(150, 80), (77, 13), (300, 128), (65, 33)])
def test_pre_pass_matches_split_plain_on_cuda(cuda_device, n, d):
    q, k, v, g, _ = _cuda_case(cuda_device, 2, 3, n, d, "none")
    ops = tfa.split_bwd(q, k, v, g)
    kr, vc = tfa.split_kernel("t", [(k, (tfa.ROWS,)), (v, (tfa.COLS,))], 2, 3, n, d)
    torch.cuda.synchronize()
    tensors = {"q": q, "k": k, "v": v, "g": g}
    for (name, layout), bufs in ops.items():
        for got, want in zip(bufs, tfa.split_plain(tensors[name], layout)):
            assert torch.equal(got, want), (name, layout)
    for got, want in zip((*kr[tfa.ROWS], *vc[tfa.COLS]),
                         (*tfa.split_plain(k, tfa.ROWS), *tfa.split_plain(v, tfa.COLS))):
        assert torch.equal(got, want)


def _passes_hold(q, k, v, g, mask, chunk=None):
    d = q.shape[-1]
    scale = d ** -0.5
    out, lse = tfa.flash_fwd_kernel(q, k, v, scale, mask)
    delta = tfa.delta_plain(g, out)
    dk, dv = tfa.flash_bwd_dkv_kernel(q, k, v, g, lse, delta, scale, mask)
    dq = tfa.flash_bwd_dq_kernel(q, k, v, g, lse, delta, scale, mask)
    torch.cuda.synchronize()
    b = q.shape[0]
    chunk = chunk or b
    for i in range(0, b, chunk):
        sl = slice(i, i + chunk)
        out_p, lse_p = tfa.flash_fwd_plain(q[sl], k[sl], v[sl], scale, mask)
        _hold(out[sl], out_p)
        _hold(lse[sl], lse_p)
        del out_p, lse_p
        want = tfa.flash_bwd_plain(q[sl], k[sl], v[sl], g[sl], out[sl], lse[sl], scale, mask)
        for got, ref in zip((dq[sl], dk[sl], dv[sl]), want):
            _hold(got, ref)
        del want
    return out, dq


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,kind", [(64, 6, 450, "layer_causal"), (8, 6, 300, "dead_row"),
                                        (1, 6, 13500, "none")])
def test_passes_match_plain_at_the_smoke_shapes_on_cuda(cuda_device, b, h, n, kind):
    q, k, v, g, mask = _cuda_case(cuda_device, b, h, n, 80, kind)
    out, dq = _passes_hold(q, k, v, g, mask, chunk=8)
    if kind == "dead_row":
        torch.testing.assert_close(out[:, :, DEAD], v.mean(2), rtol=0, atol=1e-5)
        assert torch.equal(dq[:, :, DEAD], torch.zeros_like(dq[:, :, DEAD]))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [13, 16, 33, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_passes_match_plain_at_every_head_dim_on_cuda(cuda_device, d, kind):
    q, k, v, g, mask = _cuda_case(cuda_device, 2, 3, 150, d, kind)
    _passes_hold(q, k, v, g, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("d", PADDED_HEAD_DIMS)
@pytest.mark.parametrize("kind", ["none", "all_true", "layer_causal"])
def test_forward_keeps_the_split_accuracy_on_cuda(cuda_device, d, kind):
    n = 198
    q, k, v, _, _ = _cuda_case(cuda_device, 2, 2, n, d, "none")
    mask = {"none": None, "all_true": torch.ones(n, n, dtype=torch.bool, device=cuda_device),
            "layer_causal": torch.from_numpy(_mask("layer_causal", n)).to(cuda_device)}[kind]
    out, _ = tfa.flash_fwd_kernel(q, k, v, d ** -0.5, mask)
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * d ** -0.5
    if mask is not None:
        s = s.masked_fill(~mask, -1e30)
    _hold(out, torch.matmul(torch.softmax(s, -1), v.double()), F64_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", PADDED_HEAD_DIMS)
def test_masked_forwards_with_all_true_masks_equal_unmasked_on_cuda(cuda_device, d):
    """K7's, K6's and K2v's masked forwards with an all-True mask against
    their unmasked kernels on the same inputs, several key tiles: within
    1e-5 of the scale (bit for bit is expected); a register A operand lost
    after a loop's first products gives errors of the operand's size."""
    from vit4hep_tpu_torch.ops import flash_qkv_attention as ffa
    from vit4hep_tpu_torch.ops import fused_dit_block as fdb

    b, h, n = 2, 2, 200
    gen = torch.Generator(device=cuda_device).manual_seed(500 + d)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=cuda_device)
    q, k, v = qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    ones = torch.ones(n, n, dtype=torch.bool, device=cuda_device)
    scale = d ** -0.5
    for run in (lambda m: tfa.flash_fwd_kernel(q, k, v, scale, m)[0],
                lambda m: ffa.flash_fwd_kernel(qkv, h, scale, m)[0],
                lambda m: fdb.attention(qkv, h, scale, m)):
        _hold(run(ones).float(), run(None).float(), 1e-5)


@pytest.mark.cuda
def test_autograd_launches_each_kernel_as_expected_on_cuda(cuda_device):
    q, k, v, g, mask = _cuda_case(cuda_device, 1, 2, 200, 80, "layer_causal")
    xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    for c in (tfa.SPLIT, tfa.FWD, tfa.BWD_DKV, tfa.BWD_DQ):
        c.reset()
    tfa.flash_attention(*xs, mask).backward(g)
    torch.cuda.synchronize()
    assert (tfa.SPLIT.launches, tfa.FWD.launches, tfa.BWD_DKV.launches,
            tfa.BWD_DQ.launches) == (2, 1, 1, 1)
    out, lse = tfa.flash_fwd_plain(q, k, v, 80 ** -0.5, mask)
    for got, ref in zip((t.grad for t in xs),
                        tfa.flash_bwd_plain(q, k, v, g, out, lse, 80 ** -0.5, mask)):
        _hold(got, ref)

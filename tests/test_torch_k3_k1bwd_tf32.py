"""K1's backward in split TF32 (``csrc/qkv_bwd_tf32.cuh``: the dQ pass
``qkv_bwd_dq_tf32_kernel`` and the dK/dV pass ``qkv_bwd_dkv_tf32_kernel``,
64 rows a CTA) and K3 on the tensor cores (``csrc/energy_decoder.cu``:
``energy_decoder_tf32_kernel``, two elements a CTA, the weights streamed in
units and split on load).

CPU tests:
  - A torch emulation of K1's five backward products in split TF32 (tf32 by
    rounding the mantissa to its top 10 bits, as ``cvt.rna.tf32.f32``
    does), with the kernels' own delta (rowsum(dO * O), times N on a wholly
    masked row), held to ``chip_smoke.TOL["qkv_attn_bwd_dq"]`` = 1e-4 of
    max(1, max|plain|) against the plain backward at the ds2 training
    widths (reduced batch), the cINN head dim, 450 tokens and the padded
    head dims 16 and 128, unmasked, layer-causal and with one wholly masked
    row: the three-product split holds it, one TF32 product misses it by 10x
    or more. At a reduced ds2 shape the same emulation against JAX's
    ``fused_qkv_attention`` gradient (interpret mode), same bound.
  - The operand layouts as index maps: a transposed B staged as
    ``split_cols`` writes it (8-row chunks in the order 0, 2, 4, 6, 1, 3, 5,
    7, the 32-byte swizzle of ``put_row``), read back as wgmma reads a
    K-major swizzled operand, times an A built from accumulator registers as
    ``tf::frags`` passes them, equals the plain product; K3's one-value
    writes (``put1``) place each K index where that order reads it.
  - K3's schedule and layout: ``weight_units`` (the kernel's ``tc::unit_at``
    in Python) covers every weight of the decoder and the head's h half
    exactly once, in units of at most 4096 values; an emulation of the
    kernel (elements padded to 64 rows, two a CTA, the batch padded to even;
    every product from a unit re-laid in the B layout above, in split TF32;
    keys padded to 16 and masked) reproduces ``_reference`` and JAX's
    ``fused_energy_decoder`` in interpret mode at d_model 128 with 7 tokens
    and an odd batch, for ReLU, GELU and SiLU, at 1e-3 of the scale
    (``chip_smoke.TOL["energy_decoder"]``); which shapes take the
    tensor-core kernel.

CUDA tests (marker ``cuda``; they skip without a card) hold each new kernel
against its plain version on the same inputs, and K1's forward against f64
within 2e-5 of the scale at every padded head dim, masked and not (the
masked forward at DP = 32 had lost Q's lo fragments to ptxas, an error of
~1e-4 that its 1e-4 bound let pass): K1's passes at every padded
head dim 16-128 and d = 13 (4-byte copies), the ds2 training, ds3 and cINN
token counts and the tiles' edges, unmasked, layer-causal and with a wholly
masked row (p = 1, delta x N), the masked (2, 130, 2, 64) shape included,
at 1e-4 of the scale; K3 at batches 1, 2, 3, 255 and 256 at the ds2 widths
and at the other configs' token counts and activations, at 1e-3. Each
wrapper counts exactly one launch.
On the card: ``python -m pytest --noconftest -m cuda tests/test_torch_k3_k1bwd_tf32.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

try:  # the JAX reference; the card's machine has no JAX and runs only `-m cuda`
    import jax.numpy as jnp

    from vit4hep_tpu.ops import fused_energy_decoder as jfed
    from vit4hep_tpu.ops import fused_qkv_attention as jfqa
except ModuleNotFoundError:
    jnp = None

from vit4hep_tpu_torch.ops import fused_energy_decoder as tfed
from vit4hep_tpu_torch.ops import fused_qkv_attention as tfqa
from vit4hep_tpu_torch.ops.pos_embed import layer_causal_mask

ROOT = Path(__file__).resolve().parents[1]
K1_TOL = 1e-4  # chip_smoke.TOL["qkv_attn_bwd_dq"] and ["qkv_attn_bwd_dkv"]
K3_TOL = 1e-3  # chip_smoke.TOL["energy_decoder"]
K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)  # a chunk's 8 K rows as the kernels stage them
MASK_KINDS = ["none", "layer_causal", "dead_row"]
LAYER_GRIDS = {135: (15, 1, 9), 225: (25, 3, 3), 450: (15, 5, 6)}
DEAD = 7  # the wholly masked row


def _mask(kind, n):
    """None, the layer-causal mask of a token grid with n tokens (causal
    where none is listed), or a causal mask whose row DEAD attends to no
    key."""
    if kind == "none":
        return None
    if kind == "layer_causal":
        return layer_causal_mask(LAYER_GRIDS[n]) if n in LAYER_GRIDS else \
            np.tril(np.ones((n, n), bool))
    mask = np.tril(np.ones((n, n), bool))
    mask[DEAD] = False
    return mask


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_k3_k1", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_smoke_keeps_the_tolerances_and_names_the_new_kernels():
    smoke = _chip_smoke()
    assert smoke.TOL["energy_decoder"] == K3_TOL
    assert smoke.TOL["qkv_attn_bwd_dq"] == smoke.TOL["qkv_attn_bwd_dkv"] == K1_TOL
    for kernel, want, header in (("qkv_attn_bwd_dq", "qkv_bwd_dq_tf32_kernel", "qkv_bwd_tf32.cuh"),
                                 ("qkv_attn_bwd_dkv", "qkv_bwd_dkv_tf32_kernel",
                                  "qkv_bwd_tf32.cuh"),
                                 ("energy_decoder", "energy_decoder_tf32_kernel",
                                  "energy_decoder.cu")):
        source, replaces = smoke.REPLACES[kernel]
        assert want in source and header in source
        path = ROOT / source.split()[0].rstrip(":")
        assert path.name == header and f"{want}(" in path.read_text()
        assert replaces.startswith("vit4hep_tpu/ops/")


# kernel names as torch.profiler gives them, the smoke's group tables that
# must claim each, and the group
K1_BWD_DQ = ("void tb::qkv_bwd_dq_tf32_kernel<80, false>(float const*, float const*, "
             "float const*, float const*, unsigned char const*, float*, int, int, int, float)")
K1_BWD_DKV = K1_BWD_DQ.replace("qkv_bwd_dq_tf32_kernel<80, false>",
                               "qkv_bwd_dkv_tf32_kernel<80, true>")
K3_TC = ("void (anonymous namespace)::tc::energy_decoder_tf32_kernel<48>"
         "((anonymous namespace)::DecoderArgs)")


@pytest.mark.parametrize("name,tables,group", [
    (K1_BWD_DQ, ("FUSED_TRAIN_GROUPS", "DS3_TRAIN_GROUPS"), "K1 backward"),
    (K1_BWD_DKV, ("FUSED_TRAIN_GROUPS", "DS3_TRAIN_GROUPS"), "K1 backward"),
    (K3_TC, ("CFM_GROUPS", "CINN_GROUPS"), "K3 energy_decoder")])
def test_smoke_profile_groups_claim_the_new_kernels(name, tables, group):
    smoke = _chip_smoke()
    for table in tables:
        claims = [label for label, claims in getattr(smoke, table) if claims(name)]
        assert claims and claims[0] == group, (table, claims)


# ---------------------------------------------------------------------------
# split TF32 (CPU emulation)
# ---------------------------------------------------------------------------
def _tf32(x):
    """x rounded to the nearest tf32, ties away from zero (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_mm(a, b, terms=3):
    """a @ b in TF32 products accumulated in f32: with terms 3, hi hi + hi lo
    + lo hi (the kernels' split); with 1, hi hi alone."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.matmul(ah, bh)
    if terms == 3:
        out = out + torch.matmul(ah, _tf32(b - bh)) + torch.matmul(_tf32(a - ah), bh)
    return out


def _rel(got, want):
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def _tf32_bwd(qkv, g, out, lse, h, scale, mask, terms):
    """K1's backward as the kernels compute it: the five products in TF32,
    p = exp(where(mask, s scale, -1e30) - lse), the delta kernel's
    rowsum(dO * O), times N on a row whose lse is -1e30."""
    n = qkv.shape[1]
    q, k, v = tfqa._heads(qkv, h, 3)
    (gh,) = tfqa._heads(g, h, 1)
    delta = tfqa.delta_plain(g, out, h)
    delta = torch.where(lse == -1e30, delta * n, delta)[..., None]
    s = _split_mm(q, k.transpose(-1, -2), terms) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.exp(s - lse[..., None])
    dv = _split_mm(p.transpose(-1, -2), gh, terms)
    ds = p * (_split_mm(gh, v.transpose(-1, -2), terms) - delta) * scale
    dq = _split_mm(ds, k, terms)
    dk = _split_mm(ds.transpose(-1, -2), q, terms)
    return tfqa._merge(dq, dk, dv)


def _parts(dqkv, hd):
    return dqkv[..., :hd], dqkv[..., hd:2 * hd], dqkv[..., 2 * hd:]


@pytest.mark.parametrize("b,n,h,d", [(4, 135, 6, 80), (4, 135, 4, 48), (2, 450, 6, 80),
                                     (4, 135, 2, 16), (2, 65, 2, 128)])
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_split_tf32_backward_holds_the_f32_contract(b, n, h, d, kind):
    gen = torch.Generator().manual_seed(170 + n + d)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen)
    g = torch.randn(b, n, h * d, generator=gen)
    mask = _mask(kind, n)
    mask = None if mask is None else torch.from_numpy(mask)
    scale = d ** -0.5
    out, lse = tfqa.attention_fwd_plain(qkv, h, scale, mask)
    want = tfqa.attention_bwd_plain(qkv, g, lse, h, scale, mask)
    three = _tf32_bwd(qkv, g, out, lse, h, scale, mask, 3)
    one = _tf32_bwd(qkv, g, out, lse, h, scale, mask, 1)
    for part3, part1, ref in zip(_parts(three, h * d), _parts(one, h * d), _parts(want, h * d)):
        err3, err1 = _rel(part3, ref), _rel(part1, ref)
        assert err3 <= K1_TOL, err3
        assert err3 * 10 <= err1, (err3, err1)


@pytest.mark.skipif(jnp is None, reason="needs JAX (the reference)")
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_split_tf32_backward_matches_jax(kind):
    b, n, h, d = 2, 135, 2, 80
    rng = np.random.default_rng(180)
    qkv = rng.normal(size=(b, n, 3 * h * d)).astype(np.float32)
    g = rng.normal(size=(b, n, h * d)).astype(np.float32)
    mask = _mask(kind, n)
    jmask = None if mask is None else jnp.asarray(mask)
    _, res = jfqa._fused_fwd(jnp.asarray(qkv), h, jmask)
    want, _ = jfqa._fused_bwd(h, None, res, jnp.asarray(g))
    tmask = None if mask is None else torch.from_numpy(mask)
    x, gt = torch.from_numpy(qkv), torch.from_numpy(g)
    out, lse = tfqa.attention_fwd_plain(x, h, d ** -0.5, tmask)
    got = _tf32_bwd(x, gt, out, lse, h, d ** -0.5, tmask, 3)
    assert _rel(got, torch.from_numpy(np.array(want))) <= K1_TOL


# ---------------------------------------------------------------------------
# the operand layouts as index maps
# ---------------------------------------------------------------------------
def _swizzled(row, slot):
    """Byte of K-slot ``slot`` of ``row`` in a K-major tf32 chunk (32 bytes a
    row) as wgmma reads the 32-byte swizzle: the 16-byte half index XORed
    with (row / (128 / 32)) % (32 / 16) (hopper.cuh's rule)."""
    return row * 32 + (((slot // 4) ^ ((row // 4) % 2)) * 16) + 4 * (slot % 4)


def _put_row(row, slot):
    """Byte where ``tf::put_row`` stores K-slot ``slot`` of ``row``: halves
    swapped on rows with (row / 4) odd."""
    sw = ((row >> 2) & 1) << 4
    return row * 32 + ((sw if slot < 4 else sw ^ 16) + 4 * (slot % 4))


def _split_cols(tile):
    """A (R, DP) tile staged transposed as ``split_cols`` writes it: chunk c
    (rows 8c .. 8c+7 in K_ORDER) holds the DP columns as rows; returns
    {byte: value}."""
    r, dp = tile.shape
    mem = {}
    for c in range(r // 8):
        for e in range(dp):
            for slot in range(8):
                mem[c * dp * 32 + _put_row(e, slot)] = tile[8 * c + K_ORDER[slot], e]
    return mem


def _wgmma_b(mem, rows, chunks):
    """The (rows, 8 chunks) matrix wgmma reads from a K-major operand."""
    return torch.tensor([[mem[c * rows * 32 + _swizzled(n, slot)] for c in range(chunks)
                          for slot in range(8)] for n in range(rows)])


def _wgmma_a(acc):
    """The (64, K) A matrix wgmma reads from registers when each thread
    passes its accumulator values as ``tf::frags`` orders them (a[0] =
    v[4j], a[1] = v[4j + 2], a[2] = v[4j + 1], a[3] = v[4j + 3]); acc is
    (64, K), value 4j + 2hh + e of lane l in warp w at row 16w + l/4 + 8hh,
    column 8j + 2(l % 4) + e; fragment register a[i] of k8 step j is row
    16w + l/4 + 8 (i % 2), K index 8j + l % 4 + 4 (i // 2)."""
    m, k = acc.shape
    a = torch.full((m, k), float("nan"))
    for w in range(4):
        for lane in range(32):
            t = lane % 4
            val = {}
            for j in range(k // 8):
                for hh in range(2):
                    for e in range(2):
                        val[4 * j + 2 * hh + e] = acc[16 * w + lane // 4 + 8 * hh, 8 * j + 2 * t + e]
            for j in range(k // 8):
                for i, src in enumerate((4 * j, 4 * j + 2, 4 * j + 1, 4 * j + 3)):
                    a[16 * w + lane // 4 + 8 * (i % 2), 8 * j + t + 4 * (i // 2)] = val[src]
    return a


@pytest.mark.parametrize("r,dp", [(32, 80), (16, 48), (16, 128)])
def test_register_a_times_transposed_b_is_the_plain_product(r, dp):
    gen = torch.Generator().manual_seed(190 + r + dp)
    p = torch.randn(64, r, generator=gen)   # P (or dS) in accumulator registers
    tile = torch.randn(r, dp, generator=gen)  # dO, Q or K rows of a streamed tile
    a = _wgmma_a(p)
    b = _wgmma_b(_split_cols(tile), dp, r // 8)
    torch.testing.assert_close(a @ b.T, p @ tile, rtol=1e-5, atol=1e-5)


def test_k3_put1_places_each_k_index_in_the_chunk_order():
    """``put1``'s slot (k8 >> 1) + ((k8 & 1) << 2) is where K_ORDER reads
    k8, and its byte is ``put_row``'s."""
    for k8 in range(8):
        slot = (k8 >> 1) + ((k8 & 1) << 2)
        assert K_ORDER[slot] == k8
        for row in range(16):
            assert (slot * 4) ^ (((row >> 2) & 1) << 4) == _put_row(row, slot) - row * 32


# ---------------------------------------------------------------------------
# K3: the unit schedule and an emulation of the tensor-core kernel
# ---------------------------------------------------------------------------
def weight_units(depth, fdim, hdim0, te, dm=128, head_dim=32):
    """The tensor-core kernel's weight units in the order it consumes them
    (energy_decoder.cu, ``tc::unit_at``, written out in Python): (matrix, layer or None, first row,
    rows, columns), the columns in the order of the unit's B rows. Per layer
    and head the four 32-row slabs of q_h | k_h | v_h, then Wo's head_dim
    rows of that head; per 64-column chunk of the feed-forward hidden layer
    W1's two 64-row slabs, then W2's two 32-row slabs; after the layers, per
    64-column chunk of the head's hidden layer, the two 64-row slabs of
    hw0's h half (its time-feature rows enter as a bias)."""
    units = []
    for layer in range(depth):
        for h in range(dm // head_dim):
            qkv = [g * dm + head_dim * h + i for g in range(3) for i in range(head_dim)]
            units += [("wqkv", layer, 32 * s, 32, qkv) for s in range(dm // 32)]
            units.append(("wo", layer, head_dim * h, head_dim, list(range(dm))))
        for c in range(fdim // 64):
            units += [("w1", layer, 64 * s, 64, list(range(64 * c, 64 * c + 64)))
                      for s in range(dm // 64)]
            units += [("w2", layer, 64 * c + 32 * s, 32, list(range(dm))) for s in range(2)]
    for c in range(hdim0 // 64):
        units += [("hw0", None, te + 64 * s, 64, list(range(64 * c, 64 * c + 64)))
                  for s in range(dm // 64)]
    return units


def test_weight_units_cover_every_weight_once():
    depth, fdim, hn, te, dm = 2, 192, 128, 16, 128
    seen = {"wqkv": np.zeros((depth, dm, 3 * dm), int), "wo": np.zeros((depth, dm, dm), int),
            "w1": np.zeros((depth, dm, fdim), int), "w2": np.zeros((depth, fdim, dm), int),
            "hw0": np.zeros((te + dm, hn), int)}
    units = weight_units(depth, fdim, hn, te)
    assert len(units) == depth * (20 + fdim // 16) + hn // 32
    for name, layer, row0, rows, cols in units:
        assert rows % 8 == 0 and rows * len(cols) <= 4096 and len(cols) % 8 == 0
        block = seen[name] if layer is None else seen[name][layer]
        block[row0:row0 + rows, cols] += 1
    assert all((v == 1).all() for k, v in seen.items() if k != "hw0")
    assert (seen["hw0"][:te] == 0).all() and (seen["hw0"][te:] == 1).all()


def _decoder_args(rng, b, n, dm=128, te=16, fdim=128, hn=64, depth=2):
    def w(*shape, s=0.1):
        return (rng.normal(size=shape) * s).astype(np.float32)

    return [w(b, n, dm, s=1.0), w(b, te, s=1.0), w(b, depth, dm),
            1.0 + w(depth, 3, dm), w(depth, 3, dm),
            w(depth, dm, 3 * dm), w(depth, 3 * dm), w(depth, dm, dm), w(depth, dm),
            w(depth, dm, fdim), w(depth, fdim), w(depth, fdim, dm), w(depth, dm),
            1.0 + w(dm), w(dm), w(te + dm, hn), w(hn), w(hn, 1), w(1)]


def _ln(x, s, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * s + b


def _tc_emulation(tgt, tf, cross, ln_s, ln_b, wqkv, bqkv, wo, bo, w1, b1, w2, b2, fs, fb,
                  hw0, hb0, hw1, hb1, activation):
    """The tensor-core kernel's arithmetic on the CPU: elements padded to
    64 rows, two a CTA (the batch padded to even with zero elements), the
    weights consumed in ``weight_units`` order, each unit re-laid as the
    kernel's B operand (K rows in K_ORDER within each chunk of 8) against
    an A whose columns take the same order, every product in split TF32."""
    b, n, dm = tgt.shape
    depth, fdim, te, hn = w1.shape[0], w1.shape[-1], tf.shape[1], hw0.shape[1]
    nk, rows, e = -(-n // 16) * 16, 64, -(-b // 2) * 2
    x = torch.zeros(e, rows, dm)
    x[:b, :n] = tgt
    crs = torch.zeros(e, depth, dm)
    crs[:b] = cross
    tfp = torch.zeros(e, te)
    tfp[:b] = tf
    mats = {"wqkv": wqkv, "wo": wo, "w1": w1, "w2": w2, "hw0": hw0}
    units = iter(weight_units(depth, fdim, hn, te))
    order = torch.tensor(K_ORDER)

    def product(a, unit):
        name, layer, row0, nrow, cols = unit
        w = mats[name] if layer is None else mats[name][layer]
        blk = w[row0:row0 + nrow][:, cols]                          # (K_u, N_u)
        bt = blk.reshape(nrow // 8, 8, len(cols))[:, order].reshape(nrow, len(cols))
        a_hw = a.reshape(*a.shape[:-1], nrow // 8, 8)[..., order].reshape(a.shape)
        return _split_mm(a_hw, bt)

    act = {"relu": F.relu, "gelu": lambda v: F.gelu(v, approximate="tanh"),
           "silu": F.silu}[activation]
    keys = torch.arange(nk) < n
    for l in range(depth):
        o = torch.zeros(e, rows, dm)
        for h in range(4):
            qkv = torch.zeros(e, rows, 96)
            for s in range(4):
                qkv = qkv + product(x[..., 32 * s:32 * s + 32], next(units))
            qkv = qkv + torch.cat([bqkv[l, g * dm + 32 * h:g * dm + 32 * h + 32]
                                   for g in range(3)])
            q, k, v = qkv[..., :32], qkv[..., 32:64][:, :nk], qkv[..., 64:][:, :nk]
            sc = _split_mm(q, k.transpose(-1, -2)) * 32 ** -0.5
            sc = torch.where(keys, sc, torch.full_like(sc, -float("inf")))
            p = torch.exp(sc - sc.amax(-1, keepdim=True))
            ctx = _split_mm(p, v) / p.sum(-1, keepdim=True)
            o = o + product(ctx, next(units))
        x = _ln(x + o + bo[l], ln_s[l, 0], ln_b[l, 0])
        x = _ln(x + crs[:, l, None, :], ln_s[l, 1], ln_b[l, 1])
        y = torch.zeros(e, rows, dm)
        for c in range(fdim // 64):
            hc = torch.zeros(e, rows, 64)
            for kh in range(2):
                hc = hc + product(x[..., 64 * kh:64 * kh + 64], next(units))
            hc = act(hc + b1[l, 64 * c:64 * c + 64])
            for s in range(2):
                y = y + product(hc[..., 32 * s:32 * s + 32], next(units))
        x = _ln(x + y + b2[l], ln_s[l, 2], ln_b[l, 2])
    x = _ln(x, fs, fb)
    tfb = hb0 + tfp @ hw0[:te]  # the time-feature half, on the CUDA cores
    out = torch.zeros(e, rows)
    for c in range(hn // 64):
        hid = torch.zeros(e, rows, 64)
        for kh in range(2):
            hid = hid + product(x[..., 64 * kh:64 * kh + 64], next(units))
        hid = F.silu(hid + tfb[:, None, 64 * c:64 * c + 64])
        out = out + (hid * hw1[64 * c:64 * c + 64, 0]).sum(-1)
    assert next(units, None) is None
    return (out + hb1)[:b, :n]


@pytest.mark.parametrize("activation", ["relu", "gelu", "silu"])
def test_tc_emulation_matches_the_plain_version(activation):
    args = [torch.from_numpy(a) for a in _decoder_args(np.random.default_rng(200), b=3, n=7)]
    got = _tc_emulation(*args, activation)
    assert got.shape == (3, 7)
    assert _rel(got, tfed._reference(*args, num_heads=4, activation=activation)) <= K3_TOL


@pytest.mark.skipif(jnp is None, reason="needs JAX (the reference)")
@pytest.mark.parametrize("activation", ["relu", "gelu", "silu"])
def test_tc_emulation_matches_jax(activation):
    """JAX's kernel in interpret mode (f32 products; jax.nn.gelu's default is
    the tanh form, as the port's)."""
    args = _decoder_args(np.random.default_rng(201), b=3, n=7, depth=1)
    got = _tc_emulation(*[torch.from_numpy(a) for a in args], activation)
    want = jfed.fused_energy_decoder(*[jnp.asarray(a) for a in args], 4, activation, 8)
    assert _rel(got, torch.from_numpy(np.array(want))) <= K3_TOL


@pytest.mark.parametrize("n,dm,heads,fdim,hn,depth,want", [
    (45, 128, 4, 512, 512, 4, True), (7, 128, 4, 512, 512, 4, True),
    (3, 128, 4, 512, 512, 4, True), (58, 128, 4, 512, 512, 4, True),
    (64, 128, 4, 512, 512, 4, True), (65, 128, 4, 512, 512, 4, False),
    (45, 64, 4, 128, 96, 2, False), (45, 128, 8, 512, 512, 4, False),
    (45, 128, 4, 96, 512, 4, False), (45, 128, 4, 512, 96, 4, False),
    (7, 48, 4, 40, 24, 1, False), (45, 128, 4, 512, 8192, 4, False)])
def test_tensor_core_shapes(n, dm, heads, fdim, hn, depth, want):
    assert tfed.tensor_core_shape(n, dm, heads, fdim, hn, depth) is want


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


# (B, N, H, d): the ds2 training shape (reduced batch), the cINN subnets'
# head dim, 450 tokens, the tiles' edges, every padded head dim, d = 13
# (4-byte copies), one token; (2, 130, 2, 64) masked caught a miscompiled
# dQ pass in K6 (flash_bwd_wgmma.cuh, k6_p)
K1_SHAPES = [(8, 135, 6, 80), (4, 135, 4, 48), (2, 450, 6, 80), (4, 135, 2, 16),
             (2, 65, 3, 32), (2, 130, 2, 64), (2, 200, 2, 96), (1, 130, 2, 112),
             (2, 135, 2, 128), (2, 70, 3, 13), (2, 1, 2, 80), (1, 33, 2, 80)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,d", K1_SHAPES)
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_k1_tf32_backward_matches_plain_on_cuda(cuda_device, b, n, h, d, kind):
    gen = torch.Generator(device=cuda_device).manual_seed(210 + n + d)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=cuda_device)
    g = torch.randn(b, n, h * d, generator=gen, device=cuda_device)
    if kind == "dead_row" and n <= DEAD:
        kind = "layer_causal"
    mask = _mask(kind, n)
    mask = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    scale, hd = d ** -0.5, h * d
    out, lse = tfqa.attention_fwd_kernel(qkv, h, scale, mask)
    delta = tfqa.attention_bwd_delta_kernel(g, out, h)
    counts = [tfqa.BWD_DQ.launches, tfqa.BWD_DKV.launches]
    dqkv = torch.full_like(qkv, float("nan"))
    tfqa.attention_bwd_dkv_kernel(qkv, g, lse, delta, h, scale, dqkv, mask)
    tfqa.attention_bwd_dq_kernel(qkv, g, lse, delta, h, scale, dqkv, mask)
    torch.cuda.synchronize()
    assert [tfqa.BWD_DQ.launches - counts[0], tfqa.BWD_DKV.launches - counts[1]] == [1, 1]
    want = tfqa.attention_bwd_plain(qkv, g, lse, h, scale, mask)
    for part, got, ref in zip(("dq", "dk", "dv"), _parts(dqkv, hd), _parts(want, hd)):
        _close(got, ref, K1_TOL, part)
    if kind == "dead_row":  # p = 1 on every key: its dQ is sum_k (dp_k - N delta) scale k
        assert (lse[:, :, DEAD] == -1e30).all()
        _, k, v = tfqa._heads(qkv, h, 3)
        (gh,) = tfqa._heads(g, h, 1)
        (oh,) = tfqa._heads(out, h, 1)
        g_dead = gh[:, :, DEAD:DEAD + 1]                                 # (b, h, 1, d)
        dp = g_dead @ v.transpose(-1, -2)                                # (b, h, 1, n)
        dl = n * (g_dead * oh[:, :, DEAD:DEAD + 1]).sum(-1, keepdim=True)  # (b, h, 1, 1)
        dq_dead = ((dp - dl) * scale) @ k                                # (b, h, 1, d)
        _close(dqkv[:, DEAD, :hd], dq_dead.reshape(b, hd), K1_TOL, "dead row dq")


def _fwd64(qkv, h, scale, mask):
    """K1's forward in f64: (context, lse)."""
    q, k, v = tfqa._heads(qkv.double(), h, 3)
    s = q @ k.transpose(-1, -2) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    return tfqa._merge(torch.softmax(s, -1) @ v), torch.logsumexp(s, -1)


# the split holds K1's forward within ~2e-6 of f64 at these shapes (the CPU
# emulation above); 2e-5 of the scale leaves 10x room and catches a product
# that loses its lo terms (the masked forward at DP = 32 lost Q's from its
# second key tile on: 1.5e-4 to 2.6e-4, inside TOL's 1e-4 of a scale of 2-3)
SPLIT_ATOL = 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("kind", ["none", "ones", "layer_causal"])
def test_k1_tf32_forward_keeps_the_split_accuracy_on_cuda(cuda_device, d, kind):
    b, n, h = 2, 130, 2
    gen = torch.Generator(device=cuda_device).manual_seed(230 + d)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=cuda_device)
    mask = None if kind == "none" else (
        torch.ones(n, n, dtype=torch.bool, device=cuda_device) if kind == "ones" else
        torch.from_numpy(_mask("layer_causal", n)).to(cuda_device))
    out, lse = tfqa.attention_fwd_kernel(qkv, h, d ** -0.5, mask)
    out64, lse64 = _fwd64(qkv, h, d ** -0.5, mask)
    _close(out, out64, SPLIT_ATOL, "context")
    _close(lse, lse64, SPLIT_ATOL, "lse")


K3_SHAPES = [  # (batch, tokens, activation): the ds2 widths at the batches a request sends
    (1, 45, "relu"), (2, 45, "relu"), (3, 45, "relu"), (255, 45, "relu"), (256, 45, "relu"),
    (5, 7, "gelu"), (4, 58, "silu"), (3, 3, "relu"), (9, 64, "relu")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,activation", K3_SHAPES)
def test_k3_tensor_core_kernel_matches_plain_on_cuda(cuda_device, b, n, activation):
    args = [torch.from_numpy(a).to(cuda_device) for a in
            _decoder_args(np.random.default_rng(220 + b + n), b, n, te=64, fdim=512, hn=512,
                          depth=4)]
    assert tfed.tensor_core_shape(n, 128, 4, 512, 512, 4)
    before = tfed.ENERGY_DECODER.launches
    out = tfed.fused_energy_decoder(*args, 4, activation, 8)
    torch.cuda.synchronize()
    assert tfed.ENERGY_DECODER.launches == before + 1
    assert out.shape == (b, n) and torch.isfinite(out).all()
    _close(out, tfed._reference(*args, num_heads=4, activation=activation), K3_TOL, "velocity")

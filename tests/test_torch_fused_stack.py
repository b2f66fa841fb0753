"""Port parity of the DiT block stack, ``fused_dit_stack`` (K2s, its
no-grad forward; K5a-stack, its residual-saving forward; and its backward),
against the JAX package.

CPU tests run at the tiny shapes of the JAX package's own stack tests
(tests/test_attention.py: 2 heads x 8, F 32, N 40, depth 2), batch 3, so
that groups of 2 and 4 pad the batch to 4; unmasked and with the layer-causal
mask of the (5, 4, 2) token grid. The same numpy inputs go through JAX's
function (its Pallas kernels in interpret mode, f32, each result computed
once per module) and the port's (its plain versions, f32). Tolerances:
forwards and residuals atol 2e-5, rtol 1e-5 (f32 on both sides, summation
order only); gradients atol 2e-3, rtol 1e-4, the bound JAX's own stack
tests hold (tests/test_attention.py:860), since the gradients of sum(out^2)
through two blocks differ by summation order. Residual tiers are forced by
monkeypatching ``train_residual_bytes`` in both packages, as
tests/test_torch_fused_train.py does.

CUDA tests (marker ``cuda``; skipped without a card) hold K2s and
K5a-stack against their plain versions on bf16 multiplicands and count
their launches; on the card (no JAX there):
``python -m pytest --noconftest -m cuda tests/test_torch_fused_stack.py``.
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
from vit4hep_tpu_torch.ops import fused_qkv_attention as tfqa
from vit4hep_tpu_torch.ops.pos_embed import layer_causal_mask
from vit4hep_tpu_torch.tools import megakernel_residue, timing

HEADS, D, FDIM, N, B, DEPTH = 2, 8, 32, 40, 3, 2
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


def _stack_args(seed=41):
    """x, mods, the 8 block weights stacked (L, ...)."""
    rng = np.random.default_rng(seed)
    w = lambda *s, sc=0.1: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    return [w(B, N, HID, sc=1.0), w(B, DEPTH, 6, HID, sc=0.3),
            w(DEPTH, HID, 3 * HID), w(DEPTH, 3 * HID), w(DEPTH, HID, HID), w(DEPTH, HID),
            w(DEPTH, HID, FDIM), w(DEPTH, FDIM), w(DEPTH, FDIM, HID), w(DEPTH, HID)]


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
    """Price out the residual tiers above ``tier``: "a1" (as computed),
    "no_a1", "recompute"."""
    orig = module.train_residual_bytes
    if tier == "no_a1":
        monkeypatch.setattr(module, "train_residual_bytes",
                            lambda n, h, f, d, rb, save_a1=True:
                            (1 << 40) if save_a1 else orig(n, h, f, d, rb, save_a1))
    elif tier == "recompute":
        monkeypatch.setattr(module, "train_residual_bytes", lambda *a, **k: 1 << 40)


FORWARDS = [(1, False), (1, True), (2, False), (4, False), (4, True)]


@pytest.mark.parametrize("group,masked", FORWARDS,
                         ids=[f"g{g}-{'causal' if m else 'unmasked'}" for g, m in FORWARDS])
def test_stack_forward_matches_jax(group, masked):
    """K2s without gradients against JAX ``fused_dit_stack`` (``_stack_fwd``,
    grouped for G > 1: batch 3 pads to 4 and is sliced back), and the
    port's result is the same for every group."""
    args = _stack_args()
    ref = _once(("fwd", group, masked), lambda: jfdb.fused_dit_stack(
        *args, _mask(masked), HEADS, SCALE, group))
    with torch.no_grad():
        out = tfdb.fused_dit_stack(*_t(args), _mask(masked, torch_=True), HEADS, SCALE, group)
    _close([out], [ref], what=f"K2s group {group}")
    assert out.shape == (B, N, HID)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "causal"])
def test_stack_fwd_train_matches_jax(masked):
    """K5a-stack's output and residual set against JAX ``_stack_fwd_train``;
    the lse of each block is the attention's log-sum-exp of its saved qkv."""
    args = _stack_args()
    out, (_, saved) = _once(("fwd_train", masked), lambda: jfdb._stack_fwd_train(
        *args, _mask(masked), HEADS, SCALE))
    tmask = _mask(masked, torch_=True)
    port, res, lses = tfdb.stack_fwd_train(*_t(args), tmask, HEADS, SCALE)
    _close([port, *res], [out, *saved], what="K5a-stack")
    assert res[0].shape == (B, DEPTH + 1, N, HID) and lses.shape == (B, DEPTH, HEADS, N)
    _, lse0 = tfqa.attention_fwd_plain(res[1][:, 0], HEADS, SCALE, tmask)
    _close([lses[:, 0]], [lse0.numpy()], what="lse")


GRADS = [("a1", "pallas", False), ("a1", "xla", False), ("no_a1", "pallas", False),
         ("recompute", "pallas", False), ("a1", "pallas", True), ("recompute", "pallas", True)]


@pytest.mark.parametrize("tier,bwd,masked", GRADS,
                         ids=[f"{t}-{b}-{'causal' if m else 'unmasked'}" for t, b, m in GRADS])
def test_stack_grads_match_jax(monkeypatch, tier, bwd, masked):
    """jax.grad of JAX ``fused_dit_stack`` (``_stack_fwd_train`` /
    ``_stack_bwd``) against the port's autograd on the same tier (forced in
    both packages) and ``bwd`` arm, for x, mods and every weight; with
    residuals the backward is K5b (or the hybrid arm), without them K2b's
    recompute and K5c."""
    args = _stack_args()
    mask = _mask(masked)

    def jax_grads():
        _force_tier(monkeypatch, jfdb, tier)
        saved = jfdb._stack_fwd_train(*args, mask, HEADS, SCALE)[1][1]
        assert (saved is None) == (tier == "recompute")
        assert tier == "recompute" or (saved[3] is None) == (tier == "no_a1")
        return jax.grad(lambda *a: jnp.sum(jfdb.fused_dit_stack(
            *a, mask, HEADS, SCALE, 1, bwd) ** 2), argnums=tuple(range(10)))(*args)

    ref = _once(("grads", tier, bwd, masked), jax_grads)
    _force_tier(monkeypatch, tfdb, tier)
    ins = [t.requires_grad_() for t in _t(args)]
    out = tfdb.fused_dit_stack(*ins, _mask(masked, torch_=True), HEADS, SCALE, 1, bwd)
    (out ** 2).sum().backward()
    _close([t.grad for t in ins], ref, atol=GRAD_ATOL, rtol=GRAD_RTOL, what=f"{tier} {bwd}")


def test_stack_refuses_what_jax_refuses():
    """A batched mask raises ValueError in both packages; the port also
    refuses an unknown backward arm."""
    args = _stack_args()
    batched = np.ones((B, N, N), bool)
    with pytest.raises(ValueError, match="shared"):
        jfdb.fused_dit_stack(*args, jnp.asarray(batched), HEADS, SCALE)
    with pytest.raises(ValueError, match="shared"):
        tfdb.fused_dit_stack(*_t(args), torch.from_numpy(batched), HEADS, SCALE)
    with pytest.raises(ValueError, match="bwd"):
        tfdb.fused_dit_stack(*_t(args), None, HEADS, SCALE, 1, "nope")


def test_megakernel_residue_refuses_the_cpu():
    """K10's harness imports on a host without a card; it refuses CPU
    tensors, naming them, and its command line exits non-zero here."""
    inputs = megakernel_residue.make_inputs(10, 2, hdim=16, fdim=32, device="cpu")
    with pytest.raises(ValueError, match="not on a CUDA device"):
        megakernel_residue.itemize(inputs, HEADS)
    if not torch.cuda.is_available():
        assert megakernel_residue.main(["ds2"]) == 2
    assert megakernel_residue.main(["ds4"]) == 2


@pytest.mark.parametrize("nbytes, flops, rate, by", [
    (3.35e9, 1e9, timing.BF16_FLOPS, "bytes"),
    (1e6, 6.7e10, timing.F32_FLOPS, "operations"),
])
def test_work_bound_is_the_larger_time(nbytes, flops, rate, by):
    """The smoke's and K10's bound: the larger of the bytes over the HBM
    rate and the operations over the peak of their type, in ms."""
    ms, got = timing.work_bound(nbytes, flops, rate)
    want = max(nbytes / timing.HBM_BYTES_S, flops / rate) * 1e3
    assert got == by and ms == pytest.approx(want, rel=1e-12)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, 'PyTorch port')")
    return torch.device("cuda")


def _cuda_args(device, b=4, n=135, hid=96, heads=2, fdim=192, depth=3):
    gen = torch.Generator(device=device).manual_seed(42)
    r = lambda *s, sc=0.05: torch.randn(*s, generator=gen, device=device) * sc  # noqa: E731
    return [r(b, n, hid, sc=1.0), r(b, depth, 6, hid, sc=0.3), r(depth, hid, 3 * hid),
            r(depth, 3 * hid), r(depth, hid, hid), r(depth, hid), r(depth, hid, fdim),
            r(depth, fdim), r(depth, fdim, hid), r(depth, hid)], heads


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_stack_kernels_match_plain_on_cuda(cuda_device, masked):
    """K2s and K5a-stack against the chained plain block forward on bf16
    multiplicands (8e-3 of scale per block: one bf16 rounding flip of a
    hidden value, as K2b's bound; 2e-2 through the stack, as K5a's), with
    L x (4 GEMM + 2 modln + 1 attention) launches for K2s."""
    args, heads = _cuda_args(cuda_device)
    depth = args[2].shape[0]
    mask = torch.from_numpy(layer_causal_mask((15, 3, 3))).to(cuda_device) if masked else None
    scale = (args[0].shape[-1] // heads) ** -0.5
    for c in (tfdb.GEMM, tfdb.MODLN, tfdb.ATTENTION):
        c.reset()
    with torch.no_grad():
        out = tfdb.fused_dit_stack(*args, mask, heads, None)
    assert (tfdb.GEMM.launches, tfdb.MODLN.launches, tfdb.ATTENTION.launches) == \
        (4 * depth, 2 * depth, depth)
    ref, saved, lses = tfdb.stack_fwd_train_plain(*args, mask, heads, scale,
                                                  mm_dtype=torch.bfloat16)
    port, res, plses = tfdb.stack_fwd_train(*args, mask, heads, None)
    torch.cuda.synchronize()
    scale_ = max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= 2e-2 * scale_
    assert (port - ref).abs().max().item() <= 2e-2 * scale_
    for got, want in zip((*res[:3], res[4], plses), (*saved[:3], saved[4], lses)):
        assert (got.float() - want).abs().max().item() <= 2e-2 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
def test_megakernel_residue_itemizes_on_cuda(cuda_device):
    """K10's table at a small shape: every segment timed, each bound below
    its time, and the segments sum to about the whole block."""
    rows = megakernel_residue.itemize(megakernel_residue.make_inputs(45, 8, device=cuda_device))
    assert [r[0] for r in rows] == ["qkv", "qk+scores+pv", "out", "mlp1", "mlp2", "glue", "full"]
    assert all(0 < r[3] < r[2] for r in rows)
    print(megakernel_residue.table("small", rows))

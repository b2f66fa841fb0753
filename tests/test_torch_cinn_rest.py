"""The rest of the cINN family in the port against the JAX package, on the
CPU: the nflows spline (``ops/rqs.nflows_rqs``), ``SubnetMLP``,
``SimpleRQSCouplingBlock`` and the energy cINN (``CaloChallengeEnergyCINN``),
``NFlowsRQSCouplingBlock`` (two-sided and one-sided, token and spatial
splits), a tiny ``CaloChallengeCINN`` per coupling type, the ViT1D kernel
twins (``fused_block``) and the cINN's sampling twin, ``AllInOneBlock`` and
``ElementwiseRQSBlock``, and the two-stage chain and ``Generator`` behind
an energy cINN (the shipped configs: tests/test_torch_cinn_configs.py).

The same numpy inputs (and the JAX params converted by
``vit4hep_tpu_torch.utils.jax_params.convert_cinn_params``) go through the
JAX function and its port in float32. Tolerances, relative to the scale
max(1, max |JAX|) of each output: forward outputs and log-determinants
1e-5 (the knots come from ``cumsum`` here and from a triangular matmul in
JAX, so only rounding differs); gradients 1e-4 of max |g|. Where JAX
reaches a Pallas kernel (the spline inverse K4, the whole-ViT kernel) it
runs in interpret mode, as its own tests run it here.

CUDA tests (marker ``cuda``) hold the kernels at the shapes this slice
gives them against their plain versions; they skip without a card. On the
card (no JAX there):
``python -m pytest --noconftest -m cuda tests/test_torch_cinn_rest.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

try:  # the JAX reference; the card's machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    from vit4hep_tpu.experiments.fused_chain import make_fused_generate as jax_make_fused_generate
    from vit4hep_tpu.models import bijectors as jbij
    from vit4hep_tpu.models.calochallenge import CaloChallengeCINN as JaxCaloChallengeCINN
    from vit4hep_tpu.models.calochallenge import CaloChallengeEnergyCINN as JaxEnergyCINN
    from vit4hep_tpu.models.vit import ViT1D as JaxViT1D
    from vit4hep_tpu.ops import rqs as jrqs
except ModuleNotFoundError:
    jax = None

from vit4hep_tpu_torch.models import bijectors as tbij
from vit4hep_tpu_torch.ops import rqs as trqs

ROOT = Path(__file__).resolve().parent.parent
L, A, R = 6, 4, 3  # the tiny ds2-like grid of tests/test_torch_cinn.py
FWD_TOL = 1e-5  # forward outputs and log-determinants, of max(1, max |JAX|)
GRAD_TOL = 1e-4  # gradients, of max |g|


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, 'PyTorch port')")
    return torch.device("cuda")


def _close(got, want, tol=FWD_TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} > {tol:g} x {scale:.3g}"


def _grad_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= GRAD_TOL * max(scale, 1e-30), f"{what}: {err:.3e} > {GRAD_TOL:g} x {scale:.3g}"


def _perturbed(params, rng, std=0.05):
    """Random params everywhere (the output layers init to zero)."""
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + rng.normal(0, std, a.shape).astype(np.float32),
        params)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# the nflows spline
# ---------------------------------------------------------------------------
def _nflows_inputs(rng, b, d, bins, bound, spread):
    """theta ~ N(0, 1) and x ~ N(0, (spread bound)^2): with spread 0.5 about
    a third of 12-value events have a value outside [-bound, bound]."""
    theta = rng.normal(size=(b, d, 3 * bins - 1)).astype(np.float32)
    x = (rng.normal(size=(b, d)) * spread * bound).astype(np.float32)
    return x, theta


@pytest.mark.parametrize("event_mask", [True, False])
@pytest.mark.parametrize("rev", [False, True])
def test_nflows_rqs_matches_jax(rev, event_mask):
    """nflows_rqs both ways, gated by event and by value, on events of which
    some leave the domain: y and the log-determinant within 1e-5 of the
    scale, the gradients of sum(y^2) + sum(logdet) with respect to x and
    theta within 1e-4 of max |g|."""
    bins, bound = 8, 4.0
    x, theta = _nflows_inputs(np.random.default_rng(20), 16, 12, bins, bound, 0.5)
    inside = (np.abs(x) <= bound).all(1)
    assert 0 < inside.sum() < len(inside)

    def jloss(x, theta):
        y, ld = jrqs.nflows_rqs(x, theta, bins, bound, rev=rev, event_mask=event_mask)
        return jnp.sum(y ** 2) + jnp.sum(ld), (y, ld)

    (_, (y_r, ld_r)), (gx_r, gt_r) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(theta))
    xt, tt = _t(x).requires_grad_(), _t(theta).requires_grad_()
    y_p, ld_p = trqs.nflows_rqs(xt, tt, bins, bound, rev=rev, event_mask=event_mask)
    ((y_p ** 2).sum() + ld_p.sum()).backward()
    _close(y_p.detach(), y_r, what="y")
    _close(ld_p.detach(), ld_r, what="logdet")
    _grad_close(xt.grad, gx_r, "dx")
    _grad_close(tt.grad, gt_r, "dtheta")
    if event_mask:  # an event outside the domain passes through untouched
        out = ~inside
        assert np.array_equal(y_p.detach().numpy()[out], x[out])
        assert (ld_p.detach().numpy()[out] == 0).all()
        assert (tt.grad.numpy()[out] == 0).all()


@pytest.mark.parametrize("bound", [4.0, 20.0, 23.0, 25.0])
def test_nflows_event_gate_at_the_shipped_bounds(bound):
    """At each shipped bound (cinn_nflows 4, _ds3 20, _oneside 23,
    cinn_energy 25) the gate passes an event with one value outside
    through with logdet 0 and no gradient into its spline parameters,
    while the inverse undoes the forward on the events inside (3e-4 of
    the bound: two Newton steps in f32)."""
    bins = 14
    x, theta = _nflows_inputs(np.random.default_rng(int(bound)), 12, 45, bins, bound, 0.4)
    x[::3, 7] = 1.5 * bound  # every third event leaves the domain
    inside = (np.abs(x) <= bound).all(1)
    tt = _t(theta).requires_grad_()
    y, ld = trqs.nflows_rqs(_t(x), tt, bins, bound)
    (y.sum() + ld.sum()).backward()
    assert not inside[::3].any() and inside.any()
    assert torch.equal(y[~inside], _t(x)[~inside]) and (ld[~inside] == 0).all()
    assert (tt.grad[~inside] == 0).all() and (tt.grad[inside] != 0).any()
    x_back, ld_inv = trqs.nflows_rqs(y.detach(), _t(theta), bins, bound, rev=True)
    _close(x_back[inside], x[inside], 3e-4, "round trip")
    _close(ld_inv[inside], -ld.detach()[inside], 3e-3, "inverse logdet")


# ---------------------------------------------------------------------------
# flat-vector blocks: SubnetMLP, SimpleRQS (the energy cINN), AllInOne, ElementwiseRQS
# ---------------------------------------------------------------------------
def _block_pair(jblock, tblock, x, c, rng):
    """(JAX params) of a block, perturbed and converted into the port's."""
    from vit4hep_tpu_torch.utils.jax_params import convert_cinn_params

    args = (x,) if c is None else (x, c)
    params = _perturbed(jblock.init(jax.random.PRNGKey(0), *args), rng, 0.02)
    sd = convert_cinn_params({"blocks_0": params["params"]})
    tblock.load_state_dict({k[len("blocks.0."):]: v for k, v in sd.items()})
    return params


def _hold_block(jblock, tblock, params, x, c):
    """forward and inverse of both blocks, within 1e-5 of the scale; the
    inverse undoes the forward."""
    jargs = (x,) if c is None else (x, c)
    targs = (_t(x),) if c is None else (_t(x), _t(c))
    with torch.no_grad():
        for method in ("forward", "inverse"):
            y_r, ld_r = jblock.apply(params, *jargs, method=method)
            y_p, ld_p = getattr(tblock, method)(*targs)
            _close(y_p, y_r, what=f"{method} y")
            _close(ld_p, np.broadcast_to(np.asarray(ld_r), (x.shape[0],)), what=f"{method} logdet")
        y, ld = tblock(*targs)
        x_back, ld_inv = tblock.inverse(y, *targs[1:])
    _close(x_back, x, 3e-4, "round trip")
    _close(ld_inv, -ld.numpy(), 3e-3, "round trip logdet")


def test_subnet_mlp_matches_jax():
    """SubnetMLP: hidden layers hidden_channels[:n_layers], ReLU, a
    zero-initialised output layer (dropout accepted, not applied)."""
    from vit4hep_tpu_torch.utils.jax_params import convert_mlp_params

    rng = np.random.default_rng(21)
    x = rng.normal(size=(5, 9)).astype(np.float32)
    jmlp = jbij.SubnetMLP(out_dim=7, hidden_channels=(16, 12, 8), n_layers=3, dropout=0.2)
    params = jmlp.init(jax.random.PRNGKey(0), x)
    mlp = tbij.SubnetMLP(9, 7, hidden_channels=(16, 12, 8), n_layers=3, dropout=0.2)
    assert float(mlp.layers[-1].weight.abs().sum()) == 0 == float(mlp.layers[-1].bias.abs().sum())
    params = _perturbed(params, rng)
    mlp.load_state_dict(convert_mlp_params(params))
    with torch.no_grad():
        _close(mlp(_t(x)), jmlp.apply(params, x), what="mlp")


@pytest.mark.parametrize("d", [45, 8])
def test_simple_rqs_coupling_matches_jax(d):
    """SimpleRQSCouplingBlock (the energy cINN's RQSplineNFlows) at d = 45
    (halves 22 and 23, in that order) and 8, bound 25 and 3, with a
    condition; some events leave the domain at d = 8."""
    rng = np.random.default_rng(22 + d)
    bound = 25.0 if d == 45 else 3.0
    kw = dict(hidden_channels=(32, 32), n_layers=2)
    jblock = jbij.SimpleRQSCouplingBlock(dims_in=d, num_bins=14, bounds_init=bound,
                                         subnet_kwargs=kw)
    block = tbij.SimpleRQSCouplingBlock(d, num_bins=14, bounds_init=bound, subnet_kwargs=kw)
    assert (block.half1, block.half2) == (d // 2, d - d // 2)
    x = (rng.normal(size=(6, d)) * (8.0 if d == 45 else 1.5)).astype(np.float32)
    c = rng.uniform(size=(6, 1)).astype(np.float32)
    params = _block_pair(jblock, block, x, c, rng)
    _hold_block(jblock, block, params, x, c)


@pytest.mark.parametrize("gin,soft,cond", [(False, False, True), (True, False, True),
                                           (False, True, False), (True, True, False)],
                         ids=["affine-hard-cond", "gin-hard-cond", "affine-soft", "gin-soft"])
def test_all_in_one_block_matches_jax(gin, soft, cond):
    """AllInOneBlock: the numpy-seeded hard permutation or SO(N) rotation,
    ActNorm (off for GIN), the soft-clamped (GIN: volume-preserving)
    coupling, with and without a condition."""
    rng = np.random.default_rng(23)
    d = 7
    x = rng.normal(size=(5, d)).astype(np.float32)
    c = rng.uniform(size=(5, 2)).astype(np.float32) if cond else None
    jblock = jbij.AllInOneBlock(dims_in=d, gin_block=gin, permute_soft=soft, seed=4,
                                global_affine_init=0.7)
    block = tbij.AllInOneBlock(d, gin_block=gin, permute_soft=soft, seed=4,
                               global_affine_init=0.7, condition_dim=2 if cond else 0)
    params = _block_pair(jblock, block, x, c, rng)
    w = np.asarray(jblock.bind(params).w_perm)
    np.testing.assert_array_equal(block.w_perm.numpy(), w)
    _hold_block(jblock, block, params, x, c)


@pytest.mark.parametrize("condition_dim", [0, 3], ids=["free", "conditional"])
def test_elementwise_rqs_block_matches_jax(condition_dim):
    """ElementwiseRQSBlock: free spline parameters (zero-initialised) or
    ones predicted from the condition; points in both tails."""
    rng = np.random.default_rng(24)
    d = 5
    x = (rng.normal(size=(6, d)) * 6).astype(np.float32)
    c = rng.uniform(size=(6, condition_dim)).astype(np.float32) if condition_dim else None
    kw = dict(bins=6, min_bin_sizes=(0.01, 0.01), default_domain=(-5.0, 5.0, -5.0, 5.0))
    jblock = jbij.ElementwiseRQSBlock(dims_in=d, condition_dim=condition_dim,
                                      subnet_kwargs={"hidden_channels": (16, 16)}, **kw)
    block = tbij.ElementwiseRQSBlock(d, condition_dim=condition_dim,
                                     subnet_kwargs={"hidden_channels": (16, 16)}, **kw)
    if not condition_dim:
        assert float(block.spline_parameters.abs().sum()) == 0
    params = _block_pair(jblock, block, x, c, rng)
    with torch.no_grad():
        for method in ("forward", "inverse"):
            y_r, ld_r = jblock.apply(params, *((x,) if c is None else (x, c)), method=method)
            y_p, ld_p = getattr(block, method)(*((_t(x),) if c is None else (_t(x), _t(c))))
            # the tails' slopes amplify a knot's rounding as in test_torch_cinn's spline test
            _close(y_p, y_r, 5e-5, f"{method} y")
            _close(ld_p, ld_r, 5e-4 / 10, f"{method} logdet")


def _energy_kwargs(nblocks=3, hidden=32):
    return dict(shape=[L], coupling_block="RQSplineNFlows", nblocks=nblocks,
                cinn_kwargs={"num_bins": 14, "bounds_init": 25},
                subnet_kwargs={"n_layers": 3, "hidden_channels": [hidden] * 3, "dropout": 0.0})


def _energy_pair(rng, **kw):
    from vit4hep_tpu_torch.models.calochallenge import CaloChallengeEnergyCINN
    from vit4hep_tpu_torch.utils.jax_params import convert_cinn_params

    jmodel = JaxEnergyCINN(**_energy_kwargs(**kw))
    params = _perturbed(jmodel.init_params(jax.random.PRNGKey(2)), rng, 0.02)
    model = CaloChallengeEnergyCINN(**_energy_kwargs(**kw))
    model.net.load_state_dict(convert_cinn_params(params))
    return jmodel, params, model


def test_energy_cinn_log_prob_and_sample_match_jax():
    """CaloChallengeEnergyCINN (cinn_energy.yaml's 14 bins, bound 25, MLPs 3
    x 32 here) over u of width L: log_prob within 1e-5 relative, the
    sample on JAX's own z within 1e-5 of the scale; each block's Permute is
    JAX's seed-i permutation of the u's."""
    rng = np.random.default_rng(25)
    jmodel, params, model = _energy_pair(rng)
    assert model.param_count() == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    for i, blk in enumerate(model.net.blocks[1::2]):
        assert blk.perm.tolist() == np.random.default_rng(i).permutation(L).tolist()
    u = rng.normal(size=(5, L)).astype(np.float32)
    c = rng.uniform(size=(5, 1)).astype(np.float32)
    ref = float(jmodel.log_prob(params, u, c))
    with torch.no_grad():
        lp = float(model.log_prob(_t(u), _t(c)))
    assert abs(lp - ref) <= FWD_TOL * abs(ref)
    key = jax.random.PRNGKey(7)
    sample_j = np.asarray(jmodel.sample_batch(params, jnp.asarray(c), key))
    z = _t(np.array(jax.random.normal(key, (5, L), jnp.float32)))
    _close(model.sample_batch(_t(c), None, z), sample_j, what="sample")


# ---------------------------------------------------------------------------
# token-sequence blocks and the shape cINN
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("one_sided", [False, True], ids=["two-sided", "one-sided"])
@pytest.mark.parametrize("spatial", [False, True], ids=["tokens", "spatial"])
def test_nflows_coupling_block_matches_jax(spatial, one_sided):
    """NFlowsRQSCouplingBlock with ViT1D subnets at 10 tokens of 6 (token
    halves of 5: an odd count; spatial halves of 3 values), bound 2 so that
    some events leave the domain: forward and inverse within 1e-5 of the
    scale, and the inverse undoes the forward."""
    from vit4hep_tpu_torch.models.vit import ViT1D

    t, p = 10, 6
    vit = dict(dim=1, condition_dim=3, hidden_dim=16, depth=1, num_heads=2, mlp_ratio=2.0,
               num_patches=[[t, 1, 1]], patch_dim=p // 2 if spatial else p,
               prod_num_patches=t if spatial else t // 2)
    kw = dict(num_bins=6, bounds_init=2.0, spatial=spatial, one_sided=one_sided)
    jblock = jbij.NFlowsRQSCouplingBlock(subnet_ctor=lambda n: JaxViT1D(dict(vit, x_out=n)),
                                         **kw)
    block = tbij.NFlowsRQSCouplingBlock(lambda n: ViT1D(dict(vit, x_out=n)), **kw)
    assert hasattr(block, "subnet2") != one_sided
    rng = np.random.default_rng(26)
    x = (rng.normal(size=(8, t, p)) * 0.5).astype(np.float32)
    c = rng.normal(size=(8, 3)).astype(np.float32)
    params = _block_pair(jblock, block, x, c, rng)
    _hold_block(jblock, block, params, x, c)


def _tiny_cinn_kwargs(coupling="CaloRQSplineFrEIA", condition_dim=5, **vit):
    cinn = ({"fused_spline": True, "bins": 10, "min_bin_sizes": [0.001, 0.001],
             "default_domain": [-8.0, 8.0, -8.0, 8.0], "identity_tails": False,
             "domain_clamping": None} if coupling == "CaloRQSplineFrEIA"
            else {"num_bins": 8, "bounds_init": 4})
    return dict(shape=[L, A, R], patch_shape=[[3, 2, 1]], in_channels=1,
                coupling_block=coupling, nblocks=4, is_spatial=[False, True, False, True],
                cinn_kwargs=cinn,
                vit_kwargs={"dim": 1, "condition_dim": condition_dim, "hidden_dim": 32,
                            "out_channels": 1, "depth": 2, "num_heads": 2, "mlp_ratio": 2.0,
                            "learn_pos_embed": True, "causal_attn": False,
                            "checkpoint_grads": False, **vit})


def _tiny_pair(rng, coupling="CaloRQSplineFrEIA", condition_dim=5, **vit):
    from vit4hep_tpu_torch.models.calochallenge import CaloChallengeCINN
    from vit4hep_tpu_torch.utils.jax_params import convert_cinn_params

    kw = _tiny_cinn_kwargs(coupling, condition_dim, **vit)
    jmodel = JaxCaloChallengeCINN(**kw)
    params = _perturbed(jmodel.init_params(jax.random.PRNGKey(1)), rng, 0.05)
    model = CaloChallengeCINN(**kw)
    model.net.load_state_dict(convert_cinn_params(params))
    return jmodel, params, model


@pytest.mark.parametrize("coupling", ["CaloRQSplineNFlows", "OneSidedCaloRQSplineNFlows"])
def test_tiny_cinn_per_coupling_matches_jax(coupling):
    """A tiny CaloChallengeCINN of each nflows coupling type (4 blocks, two
    of them spatial, whose Permutes act on the features; the binned type is
    held by tests/test_torch_cinn.py): log_prob within 1e-5 relative, the
    sample on JAX's z within 1e-5 of the scale."""
    rng = np.random.default_rng(27)
    jmodel, params, model = _tiny_pair(rng, coupling)
    assert model.param_count() == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert [b.axis for b in model.net.blocks[1::2]] == [1, 2, 1, 2]
    x = rng.normal(size=(3, 1, L, A, R)).astype(np.float32)
    c = rng.normal(size=(3, 5)).astype(np.float32)
    ref = float(jmodel.log_prob(params, x, c))
    with torch.no_grad():
        lp = float(model.log_prob(_t(x), _t(c)))
    assert abs(lp - ref) <= FWD_TOL * abs(ref)
    key = jax.random.PRNGKey(9)
    sample_j = np.asarray(jmodel.sample_batch(params, jnp.asarray(c), key))
    z = _t(np.array(jax.random.normal(key, jmodel.x_shape(3), jnp.float32)))
    _close(model.sample_batch(_t(c), z=z), sample_j, what="sample")


# ---------------------------------------------------------------------------
# the ViT1D kernel twins
# ---------------------------------------------------------------------------
def _vit1d_param(**kw):
    return {**dict(dim=1, condition_dim=5, hidden_dim=32, out_channels=1, depth=2, num_heads=2,
                   mlp_ratio=2.0, learn_pos_embed=True, causal_attn=False, patch_dim=6,
                   num_patches=[[12, 1, 1]], prod_num_patches=12, x_out=7), **kw}


@pytest.mark.parametrize("fused", [dict(fused_block=True), dict(fused_block="hybrid"),
                                   dict(fused_block=True, fused_stack=False)],
                         ids=["true", "hybrid", "no-stack"])
def test_vit1d_fused_trains_with_the_composed_grads(fused):
    """ViT1D with ``fused_block`` (K5a + K5b, K5a + the plain residual
    backward, K2b + K5c; their plain versions on the CPU, f32): the
    composed net's output and every parameter's gradient (summation order
    only: 1e-4 of max |g|), and the sampling twin of ``fused_block: sample``
    (K2v's plain version) its output."""
    from vit4hep_tpu_torch.models.vit import ViT1D, sampling_variant

    rng = np.random.default_rng(28)
    x, c = (_t(rng.normal(size=s)) for s in ((2, 12, 6), (2, 5)))
    torch.manual_seed(0)
    composed = ViT1D(_vit1d_param())
    with torch.no_grad():  # non-zero adaLN and final-layer weights
        for p in composed.parameters():
            p.add_(0.05 * torch.randn_like(p))
    net = ViT1D(_vit1d_param(**fused))
    net.load_state_dict(composed.state_dict())
    for m in (composed, net):
        (m(x, c) ** 2).sum().backward()
    for (name, a), b in zip(net.named_parameters(), composed.parameters()):
        _grad_close(a.grad, b.grad, name)
    sample = ViT1D(_vit1d_param(fused_block="sample"))
    sample.load_state_dict(composed.state_dict())
    twin = sampling_variant(sample)
    assert twin.cfg.fused_block is True and twin.x_embedder.weight is sample.x_embedder.weight
    with torch.no_grad():
        want = composed(x, c)
        _close(net(x, c), want, what="fused forward")
        _close(twin(x, c), want, what="sampling twin")


def test_vit1d_fused_forward_matches_jax():
    """ViT1D with ``fused_block: true``: the port's whole-ViT path (K2v's
    plain version) against JAX's Pallas kernel in interpret mode. Both take
    bf16 multiplicands with f32 accumulation, so the outputs agree to the
    kernels' precision: 1e-2 of the scale, as tests/test_torch_vit.py holds
    the fused ViT."""
    from vit4hep_tpu_torch.models.vit import ViT1D
    from vit4hep_tpu_torch.utils.jax_params import convert_vit_params

    rng = np.random.default_rng(29)
    x = rng.normal(size=(2, 12, 6)).astype(np.float32)
    c = rng.normal(size=(2, 5)).astype(np.float32)
    jnet = JaxViT1D(_vit1d_param(fused_block=True))
    params = _perturbed(jnet.init(jax.random.PRNGKey(0), x, c), rng)
    ref = np.asarray(jnet.apply(params, x, c))
    net = ViT1D(_vit1d_param(fused_block=True))
    net.load_state_dict(convert_vit_params(params))
    with torch.no_grad():
        _close(net(_t(x), _t(c)), ref, 1e-2, "fused ViT1D")


def test_cinn_sampling_twin_matches_jax():
    """``vit_kwargs.fused_block: sample``: sampling runs the flow whose
    subnets are their kernel twins (the same parameters and permutations;
    K2v's and K4's plain versions here, JAX's Pallas kernels in interpret
    mode there): within 1e-2 of the scale, the twins' bf16 products; the
    likelihood stays on the composed f32 flow (log_prob 1e-5 relative)."""
    rng = np.random.default_rng(30)
    jmodel, params, model = _tiny_pair(rng, fused_block="sample")
    twin = model.sample_net
    assert twin is not model.net and len(list(twin.parameters())) == len(list(model.parameters()))
    assert all(a is b for a, b in zip(twin.parameters(), model.net.parameters()))
    assert twin.blocks[0].subnet1.cfg.fused_block is True
    assert model.net.blocks[0].subnet1.cfg.fused_block == "sample"
    x = rng.normal(size=(3, 1, L, A, R)).astype(np.float32)
    c = rng.normal(size=(3, 5)).astype(np.float32)
    ref = float(jmodel.log_prob(params, x, c))
    with torch.no_grad():
        assert abs(float(model.log_prob(_t(x), _t(c))) - ref) <= FWD_TOL * abs(ref)
    key = jax.random.PRNGKey(11)
    sample_j = np.asarray(jmodel.sample_batch(params, jnp.asarray(c), key))
    z = _t(np.array(jax.random.normal(key, jmodel.x_shape(3), jnp.float32)))
    _close(model.sample_batch(_t(c), z=z), sample_j, 1e-2, "sample")


# ---------------------------------------------------------------------------
# the chain behind an energy cINN
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape_kind", ["cinn", "cfm"])
def test_generator_behind_energy_cinn_matches_jax(tmp_path, shape_kind):
    """Generator (energy cINN -> u map -> cINN or CFM shape model) against
    JAX make_fused_generate with the noise JAX draws: the energy noise goes
    to the energy cINN's ``sample_batch`` positionally, as its z. u and the
    shower within 1e-4, the tolerance of tests/test_torch_chain.py."""
    from tests.test_torch_cinn import _cinn_pipelines
    from vit4hep_tpu_torch.models.calochallenge import CaloChallengeCFM
    from vit4hep_tpu_torch.models.vit import ViT
    from vit4hep_tpu_torch.utils.jax_params import convert_vit_params
    from vit4hep_tpu_torch.utils.serving import Generator

    (shape_tf, energy_tf), (jshape_tf, jenergy_tf) = _cinn_pipelines(tmp_path)
    b = 4
    rng = np.random.default_rng(31)
    jenergy, pe, energy = _energy_pair(rng)
    if shape_kind == "cinn":
        jshape, ps, shape = _tiny_pair(rng, condition_dim=L + 1)
    else:
        from vit4hep_tpu.models.calochallenge import CaloChallengeCFM as JaxCFM
        from vit4hep_tpu.models.vit import ViT as JaxViT

        vit = dict(dim=3, condition_dim=L + 1, hidden_dim=48, depth=2, num_heads=2,
                   mlp_ratio=2, num_patches=[[2, 1, 3]], patch_dim=12, attn_impl="xla")
        ode = {"method": "rk4", "options": {"step_size": 0.25}}
        jshape = JaxCFM(JaxViT(vit), patch_shape=[3, 4, 1], shape=[L, A, R], odeint_kwargs=ode)
        ps = _perturbed(jshape.init_params(jax.random.PRNGKey(4)), rng)
        shape = CaloChallengeCFM(ViT(vit), patch_shape=[3, 4, 1], shape=[L, A, R],
                                 odeint_kwargs=ode)
        shape.net.load_state_dict(convert_vit_params(ps))
    gen = Generator(shape, energy, energy_tf, shape_tf, batch=b)
    cond = gen.condition(10 ** rng.uniform(3, 6, b))
    key = jax.random.PRNGKey(3)
    shower_j, cond_j = jax.jit(jax_make_fused_generate(jshape, jenergy, jenergy_tf, jshape_tf))(
        ps, pe, jnp.asarray(cond), key)
    k_u, k_s = jax.random.split(key)
    s_shape = jshape.x_shape(b) if shape_kind == "cinn" else shape.token_shape(b)
    noise = (_t(np.array(jax.random.normal(k_u, (b, L), jnp.float32))),
             _t(np.array(jax.random.normal(k_s, s_shape, jnp.float32))))
    shower_t, cond_t = gen.generate(cond, noise=noise)
    np.testing.assert_allclose(cond_t.numpy(), np.asarray(cond_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(shower_t.numpy(), np.asarray(shower_j), atol=1e-4, rtol=1e-4)
    mev = gen.sample_showers(10 ** rng.uniform(3, 6, b), seed=2)  # drawn from the generator
    assert mev.shape == (b, L * A * R) and np.isfinite(mev).all() and (mev >= 0).all()


# ---------------------------------------------------------------------------
# the kernels at this slice's shapes, on the card
# ---------------------------------------------------------------------------
def _k1_case(device, b, n, heads, d):
    from vit4hep_tpu_torch.ops import fused_qkv_attention as fqa

    gen = torch.Generator(device=device).manual_seed(n + d)
    qkv = torch.randn(b, n, 3 * heads * d, generator=gen, device=device)
    g = torch.randn(b, n, heads * d, generator=gen, device=device)
    scale = d ** -0.5
    out, lse = fqa.attention_fwd_kernel(qkv, heads, scale, None)
    out_p, lse_p = fqa.attention_fwd_plain(qkv, heads, scale, None)
    delta = fqa.attention_bwd_delta_kernel(g, out, heads)
    dqkv = torch.zeros_like(qkv)
    fqa.attention_bwd_dkv_kernel(qkv, g, lse, delta, heads, scale, dqkv, None)
    fqa.attention_bwd_dq_kernel(qkv, g, lse, delta, heads, scale, dqkv, None)
    want = fqa.attention_bwd_plain(qkv, g, lse_p, heads, scale, None)
    torch.cuda.synchronize()
    for got, ref in ((out, out_p), (lse, lse_p), (dqkv, want)):
        assert (got - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,heads,d", [(64, 135, 4, 48), (16, 135, 6, 60), (16, 270, 6, 60),
                                         (4, 675, 4, 90)],
                         ids=["ds2-train-4x48", "nflows-135-6x60", "nflows-270-6x60",
                              "nflows-ds3-675-4x90"])
def test_k1_at_the_cinn_shapes_on_cuda(cuda_device, b, n, heads, d):
    """K1's forward and backward at the cINN subnets' head dims (48, 60, 90:
    padded by the kernels) and token counts (675: between K1's 450 and K7's
    1025) against the plain versions, 1e-4 of the scale (chip_smoke's TOL)."""
    _k1_case(cuda_device, b, n, heads, d)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", ["sample", True, "hybrid", "nostack"])
def test_vit1d_kernel_twins_on_cuda(cuda_device, fused):
    """The ViT1D subnet of cinn_ds2_electrons (hidden 192, depth 3, 4 heads x
    48, 135 tokens x 24, x_out 31) through its kernel twin against the
    composed f32 net on the card: the output within 2e-2 of the scale (the
    whole-ViT kernels' bf16 bound, chip_smoke's TOL["fused_vit_forward"]),
    and under a gradient every parameter's gradient within 3e-2 relative
    L2 (FUSED_TRAIN_TOL["grad_rel_l2"])."""
    from vit4hep_tpu_torch.models.vit import ViT1D, sampling_variant

    param = dict(dim=1, condition_dim=46, hidden_dim=192, out_channels=1, depth=3, num_heads=4,
                 mlp_ratio=4.0, patch_dim=24, num_patches=[[15, 2, 9]], prod_num_patches=135,
                 x_out=31)
    torch.manual_seed(0)
    composed = ViT1D(param).to(cuda_device)
    with torch.no_grad():
        for p in composed.parameters():
            p.add_(0.02 * torch.randn_like(p))
    kw = {"fused_block": True, "fused_stack": False} if fused == "nostack" else \
        {"fused_block": fused}
    net = ViT1D(dict(param, **kw)).to(cuda_device)
    net.load_state_dict(composed.state_dict())
    x = torch.randn(16, 135, 24, device=cuda_device)
    c = torch.rand(16, 46, device=cuda_device)
    with torch.no_grad():
        want = composed(x, c)
        got = (sampling_variant(net) if fused == "sample" else net)(x, c)
    assert (got - want).abs().max().item() <= 2e-2 * max(1.0, want.abs().max().item())
    if fused == "sample":
        return
    for m in (composed, net):
        (m(x, c) ** 2).mean().backward()
    for (name, a), b in zip(net.named_parameters(), composed.parameters()):
        if b.grad.norm() > 0:
            assert ((a.grad - b.grad).norm() / b.grad.norm()).item() <= 3e-2, name

"""Port parity of the cINN sampling slice against the JAX package: the
binned spline (``ops/rqs.py``), the spline inverse (kernel K4,
``ops/fused_spline.py``), ``Permute``, the ViT1D subnet, the coupling
block, a tiny ``CaloChallengeCINN`` and the two-stage ``Generator`` with a
cINN shape model.

CPU tests: the same numpy inputs (and, for the nets, the JAX params
converted by ``vit4hep_tpu_torch.utils.jax_params.convert_cinn_params``) go
through the JAX function and the port's counterpart in float32. Where JAX
reaches its Pallas spline kernel, it runs in interpret mode, as
tests/test_cinn.py runs it here.

CUDA tests (marker ``cuda``) hold K4 against its plain version on the card;
they skip without one. On the card (no JAX there):
``python -m pytest --noconftest -m cuda tests/test_torch_cinn.py``.
"""

import numpy as np
import pytest
import torch

try:  # the JAX reference; the card's machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    from vit4hep_tpu.data.calochallenge.transforms import build_pipeline as jax_build_pipeline
    from vit4hep_tpu.experiments.fused_chain import make_fused_generate as jax_make_fused_generate
    from vit4hep_tpu.models import bijectors as jbij
    from vit4hep_tpu.models.calochallenge import CaloChallengeCINN as JaxCaloChallengeCINN
    from vit4hep_tpu.models.cfm import CFM as JaxCFM
    from vit4hep_tpu.models.energy_transformer import ParallelTransformer as JaxParallelTransformer
    from vit4hep_tpu.models.vit import ViT1D as JaxViT1D
    from vit4hep_tpu.ops import fused_spline as jfs
    from vit4hep_tpu.ops import rqs as jrqs
except ModuleNotFoundError:
    jax = None

from vit4hep_tpu_torch.ops import fused_spline as tfs
from vit4hep_tpu_torch.ops import rqs as trqs

# (identity_tails, domain_clamping, bins): the four branch combinations of
# tests/test_cinn.py's kernel test
BRANCHES = [(False, None, 10), (True, None, 10), (False, 20.0, 8), (True, 15.0, 5)]
DOM = (-8.0, 8.0, -8.0, 8.0)
MIN_BIN = (0.01, 0.01)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, 'PyTorch port')")
    return torch.device("cuda")


def _spline_inputs(rng, b, d, bins, identity_tails):
    """theta ~ N(0, 1) and y ~ 6 N(0, 1): points in every bin and in both tails."""
    theta = rng.normal(size=(b, d, trqs.n_params(bins, identity_tails))).astype(np.float32)
    return (rng.normal(size=(b, d)) * 6).astype(np.float32), theta


# ---------------------------------------------------------------------------
# spline math and K4's plain version (CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("identity_tails,clamp,bins", BRANCHES)
def test_binned_rqs_matches_jax(identity_tails, clamp, bins, rev):
    """binned_constrain + binned_rqs, both directions: f32 on both sides,
    the knots from cumsum here and from a triangular matmul in JAX, so
    only rounding differs. The constrained parameters agree to atol 1e-5.
    The outputs amplify a knot's rounding by the bin's slope ratio: each
    package alone is up to 3e-5 (y) and 1.8e-4 (log-determinant, a sum of
    52 log-derivatives) from a float64 evaluation of the same function. So
    both take the bounds tests/test_cinn.py holds JAX's two spline
    inverses to: y atol 5e-5, logdet atol 5e-4."""
    x, theta = _spline_inputs(np.random.default_rng(bins), 6, 52, bins, identity_tails)
    args = (bins, MIN_BIN, DOM, identity_tails, clamp)
    ref = jrqs.binned_constrain(jnp.asarray(theta), *args)
    port = trqs.binned_constrain(torch.from_numpy(theta), *args)
    for k in ("knot_x", "knot_y", "derivs", "scale", "shift"):
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]), atol=1e-5, err_msg=k)
    y_r, ld_r = jrqs.binned_rqs(jnp.asarray(x), ref, rev=rev)
    y_p, ld_p = trqs.binned_rqs(torch.from_numpy(x), port, rev=rev)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), atol=5e-5)
    np.testing.assert_allclose(ld_p.numpy(), np.asarray(ld_r), atol=5e-4)


@pytest.mark.parametrize("identity_tails,clamp,bins", BRANCHES)
def test_fused_inverse_cpu_matches_jax_kernel(identity_tails, clamp, bins):
    """The port's wrapper on CPU tensors (its plain version) against the
    JAX Pallas kernel in interpret mode at (6, 52): JAX's own bounds of its
    kernel against the composed path, x atol 5e-5, logdet atol 5e-4. No
    launch is counted on the CPU."""
    y, theta = _spline_inputs(np.random.default_rng(100 + bins), 6, 52, bins, identity_tails)
    args = (bins, MIN_BIN, DOM, identity_tails, clamp)
    x_r, ld_r = jfs.fused_binned_rqs_inverse(jnp.asarray(y), jnp.asarray(theta), *args, group=4)
    before = tfs.INVERSE.launches
    x_p, ld_p = tfs.fused_binned_rqs_inverse(torch.from_numpy(y), torch.from_numpy(theta), *args,
                                             group=4)
    assert tfs.INVERSE.launches == before
    assert x_p.shape == (6, 52) and ld_p.shape == (6,)
    np.testing.assert_allclose(x_p.numpy(), np.asarray(x_r), atol=5e-5)
    np.testing.assert_allclose(ld_p.numpy(), np.asarray(ld_r), atol=5e-4)


def test_inverse_round_trips_forward():
    """The plain inverse undoes the forward spline (tails included)."""
    x, theta = _spline_inputs(np.random.default_rng(3), 4, 40, 10, False)
    params = trqs.binned_constrain(torch.from_numpy(theta), 10, (0.001, 0.001), DOM)
    y, ld = trqs.binned_rqs(torch.from_numpy(x), params)
    x_back, ld_inv = tfs.inverse_plain(y, torch.from_numpy(theta), 10, (0.001, 0.001), DOM)
    torch.testing.assert_close(x_back, torch.from_numpy(x), atol=3e-4, rtol=0)
    torch.testing.assert_close(ld_inv, -ld, atol=3e-3, rtol=0)


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never takes CPU tensors: it raises, it does not
    fall back to the plain version."""
    y, theta = _spline_inputs(np.random.default_rng(4), 2, 8, 10, False)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tfs.binned_rqs_inverse_kernel(torch.from_numpy(y), torch.from_numpy(theta), 10, MIN_BIN,
                                      DOM, False, None)


# ---------------------------------------------------------------------------
# flow building blocks
# ---------------------------------------------------------------------------
def test_permute_indices_match_jax():
    """Permute's indices, bit for bit, for the seeds a 20-block flow draws;
    and forward/inverse apply them along the token and feature axes."""
    from vit4hep_tpu_torch.models.bijectors import Permute

    for seed in range(20):
        ref = np.asarray(jbij.Permute(size=135, seed=seed).bind({}).perm)
        np.testing.assert_array_equal(Permute(size=135, seed=seed).perm.numpy(), ref)
    x = np.random.default_rng(5).normal(size=(3, 10, 6)).astype(np.float32)
    for axis, size in ((1, 10), (2, 6)):
        jp = jbij.Permute(size=size, axis=axis, seed=3)
        tp = Permute(size=size, axis=axis, seed=3)
        y, _ = tp(torch.from_numpy(x))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jp.apply({}, x, method="forward")[0]))
        np.testing.assert_array_equal(tp.inverse(y)[0].numpy(), x)
    explicit = Permute(size=4, indices=[2, 0, 3, 1])
    assert explicit.perm.tolist() == [2, 0, 3, 1]
    with pytest.raises(ValueError, match="not a permutation"):
        Permute(size=4, indices=[0, 0, 1, 2])


def _perturbed(params, rng, std=0.1):
    """Random params everywhere (the FinalLayer and adaLN init to zero)."""
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + rng.normal(0, std, a.shape).astype(np.float32),
        params)


def _vit1d_param(n_tok, attn_impl):
    return dict(dim=1, condition_dim=5, hidden_dim=32, out_channels=1, depth=2, num_heads=2,
                mlp_ratio=2.0, learn_pos_embed=True, causal_attn=False, patch_dim=6,
                num_patches=[[n_tok, 1, 1]], prod_num_patches=n_tok, x_out=7,
                attn_impl=attn_impl)


@pytest.mark.parametrize("n_tok,attn_impl", [(10, "xla"), (130, "auto")])
def test_vit1d_matches_jax(n_tok, attn_impl):
    """ViT1DNet with converted params, atol 1e-5. At 130 tokens ``auto``
    takes the native-layout attention in both packages (K1's plain version
    here, the JAX kernel in interpret mode)."""
    from vit4hep_tpu_torch.models.vit import ViT1D
    from vit4hep_tpu_torch.utils.jax_params import convert_vit_params

    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, n_tok, 6)).astype(np.float32)
    c = rng.normal(size=(2, 5)).astype(np.float32)
    jnet = JaxViT1D(_vit1d_param(n_tok, attn_impl))
    params = _perturbed(jnet.init(jax.random.PRNGKey(0), x, c), rng)
    ref = np.asarray(jnet.apply(params, x, c))
    net = ViT1D(_vit1d_param(n_tok, attn_impl))
    net.load_state_dict(convert_vit_params(params))
    with torch.no_grad():
        out = net(torch.from_numpy(x), torch.from_numpy(c))
    assert out.shape == (2, n_tok, 6 * 7)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_vit1d_kernel_twin_and_unported_blocks_raise():
    from vit4hep_tpu_torch.models.calochallenge import CaloChallengeCINN
    from vit4hep_tpu_torch.models.vit import ViT1D

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ViT1D(dict(_vit1d_param(10, "auto"), fused_block="sample"))
    kw = _tiny_cinn_kwargs()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        CaloChallengeCINN(**dict(kw, coupling_block="CaloRQSplineNFlows"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        CaloChallengeCINN(**dict(kw, vit_kwargs=dict(kw["vit_kwargs"], fused_block="sample")))
    with pytest.raises(ValueError, match="Unknown Coupling block"):
        CaloChallengeCINN(**dict(kw, coupling_block="Nope"))


def _block_kwargs(fused_spline, spatial, bins=6):
    return dict(bins=bins, min_bin_sizes=(0.01, 0.01), default_domain=(-6.0, 6.0, -6.0, 6.0),
                spatial=spatial, fused_spline=fused_spline)


@pytest.mark.parametrize("spatial", [False, True])
@pytest.mark.parametrize("fused_spline", [False, True])
def test_coupling_block_matches_jax(fused_spline, spatial):
    """BinnedRQSCouplingBlock with ViT1D subnets, forward and inverse, with
    and without the fused inverse: atol 1e-5."""
    from vit4hep_tpu_torch.models.bijectors import BinnedRQSCouplingBlock
    from vit4hep_tpu_torch.models.vit import ViT1D
    from vit4hep_tpu_torch.utils.jax_params import convert_cinn_params

    t, p = 8, 6
    vit = dict(dim=1, condition_dim=3, hidden_dim=16, depth=1, num_heads=2, mlp_ratio=2.0,
               num_patches=[[t, 1, 1]], patch_dim=p // 2 if spatial else p,
               prod_num_patches=t if spatial else t // 2)
    jblock = jbij.BinnedRQSCouplingBlock(
        subnet_ctor=lambda n: JaxViT1D(dict(vit, x_out=n)), **_block_kwargs(fused_spline, spatial))
    block = BinnedRQSCouplingBlock(lambda n: ViT1D(dict(vit, x_out=n)),
                                   **_block_kwargs(fused_spline, spatial))
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, t, p)).astype(np.float32)
    c = rng.normal(size=(4, 3)).astype(np.float32)
    params = _perturbed(jblock.init(jax.random.PRNGKey(0), x, c), rng)
    sd = convert_cinn_params({"blocks_0": params["params"]})
    block.load_state_dict({k[len("blocks.0."):]: v for k, v in sd.items()})
    with torch.no_grad():
        for method in ("forward", "inverse"):
            y_r, ld_r = jblock.apply(params, x, c, method=method)
            y_p, ld_p = getattr(block, method)(torch.from_numpy(x), torch.from_numpy(c))
            np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), atol=1e-5, err_msg=method)
            np.testing.assert_allclose(ld_p.numpy(), np.asarray(ld_r), atol=1e-5, err_msg=method)


# ---------------------------------------------------------------------------
# the model and the two-stage generator
# ---------------------------------------------------------------------------
L, A, R = 6, 4, 3


def _tiny_cinn_kwargs(condition_dim=5):
    return dict(shape=[L, A, R], patch_shape=[[3, 2, 1]], in_channels=1,
                coupling_block="CaloRQSplineFrEIA", nblocks=4,
                is_spatial=[False, True, False, False],
                cinn_kwargs={"fused_spline": True, "bins": 10, "min_bin_sizes": [0.001, 0.001],
                             "default_domain": [-8.0, 8.0, -8.0, 8.0], "identity_tails": False,
                             "domain_clamping": None},
                vit_kwargs={"dim": 1, "condition_dim": condition_dim, "hidden_dim": 32,
                            "out_channels": 1, "depth": 2, "num_heads": 2, "mlp_ratio": 2.0,
                            "learn_pos_embed": True, "causal_attn": False,
                            "checkpoint_grads": False})


def _tiny_pair(rng, condition_dim=5):
    """The tiny cINN in both packages, with the JAX params (perturbed, so
    the zero-initialized final layers do not hide the subnets) converted."""
    from vit4hep_tpu_torch.models.calochallenge import CaloChallengeCINN
    from vit4hep_tpu_torch.utils.jax_params import convert_cinn_params

    jmodel = JaxCaloChallengeCINN(**_tiny_cinn_kwargs(condition_dim))
    params = _perturbed(jmodel.init_params(jax.random.PRNGKey(1)), rng, 0.05)
    model = CaloChallengeCINN(**_tiny_cinn_kwargs(condition_dim))
    model.net.load_state_dict(convert_cinn_params(params))
    return jmodel, params, model


def test_tiny_cinn_log_prob_and_sample_match_jax():
    """log_prob to 1e-5 relative; sample_batch with JAX's own z (its
    fused-spline inverse in interpret mode) to 1e-4 of scale."""
    rng = np.random.default_rng(8)
    jmodel, params, model = _tiny_pair(rng)
    assert model.num_patches == (2, 2, 3) and model.param_count() == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    x = rng.normal(size=(3, 1, L, A, R)).astype(np.float32)
    c = rng.normal(size=(3, 5)).astype(np.float32)
    ref = float(jmodel.log_prob(params, x, c))
    with torch.no_grad():
        lp = float(model.log_prob(torch.from_numpy(x), torch.from_numpy(c)))
    assert abs(lp - ref) <= 1e-5 * abs(ref)

    key = jax.random.PRNGKey(9)
    sample_j = np.asarray(jmodel.sample_batch(params, jnp.asarray(c), key))
    z = torch.from_numpy(np.array(jax.random.normal(key, jmodel.x_shape(3), jnp.float32)))
    sample_t = model.sample_batch(torch.from_numpy(c), z=z)
    assert sample_t.shape == (3, 1, L, A, R) and model.net_evals_per_sample() == 1
    np.testing.assert_allclose(sample_t.numpy(), sample_j, atol=1e-4 * np.abs(sample_j).max())
    with pytest.raises(ValueError, match="z has shape"):
        model.sample_batch(torch.from_numpy(c), z=z[:, 0])


def _energy_param():
    return dict(dims_in=L, dims_c=1, dim_embedding=16, nhead=2, num_encoder_layers=2,
                num_decoder_layers=2, dim_feedforward=32, activation="relu", embeds=True,
                encode_t_dim=16, encode_t_scale=30, fused_block="sample", fused_group=8)


def _cinn_pipelines(tmp_path):
    """The transform chains of calochallenge/cinn/calochallenge_ds2_noise
    (shape) and calochallenge/cfm/calochallenge_ds2_energy at the tiny
    geometry, built by each package: ``(port, jax)`` pairs of (shape,
    energy) step lists."""
    from tests.conftest import make_binning_xml
    from vit4hep_tpu_torch.data.calochallenge.transforms import build_pipeline

    xml = make_binning_xml(tmp_path / "binning.xml", n_layers=L, n_r=R, n_alpha=A)
    rng = np.random.default_rng(10)
    shape_dir, energy_dir = tmp_path / "shape", tmp_path / "energy"
    shape_dir.mkdir()
    energy_dir.mkdir()
    np.save(shape_dir / "means.npy", np.float32(-6.0))
    np.save(shape_dir / "stds.npy", np.float32(3.0))
    np.save(energy_dir / "means_u.npy", rng.normal(0, 0.3, L).astype(np.float32))
    np.save(energy_dir / "stds_u.npy", rng.uniform(0.8, 1.5, L).astype(np.float32))
    common = {"NormalizeByElayer": {"ptype": str(xml), "xml_file": "electron"},
              "ScaleTotalEnergy": {"n_layers": L, "factor": 0.35}}
    scale = {"LogEnergy": {}, "ScaleEnergy": {"e_min": 6.907755, "e_max": 13.815510}}
    shape_cfg = {
        **common,
        "SelectiveUniformNoise": {"a": 1.0e-7, "b": 1.0e-6, "cut": True,
                                  "exclusions": list(range(-L, 0))},
        "ExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": True},
        "GlobalStandardizeFromFile": {"model_dir": None}, **scale,
        "AddFeaturesToCond": {"split_index": L * A * R},
        "Reshape": {"shape": [1, L, A, R]}}
    energy_cfg = {
        **common, "SelectDims": {"start": -L, "end": 0},
        "ExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": True},
        "StandardizeUsFromFile": {"n_us": L, "model_dir": None}, **scale,
        "Reshape": {"shape": [L]}}
    return tuple((build(shape_cfg, str(shape_dir)), build(energy_cfg, str(energy_dir)))
                 for build in (build_pipeline, jax_build_pipeline))


def test_generator_with_cinn_matches_jax_fused_generate(tmp_path):
    """The two-stage Generator (CFM energy model -> u map -> cINN shape
    model) against JAX make_fused_generate with the noise JAX draws
    (fused_chain.py:264, cfm.py for the energy stage, cinn.py:83 for z),
    at the tolerances of tests/test_torch_chain.py."""
    from vit4hep_tpu_torch.models.cfm import CFM
    from vit4hep_tpu_torch.models.energy_transformer import ParallelTransformer
    from vit4hep_tpu_torch.utils.jax_params import convert_energy_params
    from vit4hep_tpu_torch.utils.serving import Generator

    (shape_tf, energy_tf), (jshape_tf, jenergy_tf) = _cinn_pipelines(tmp_path)
    b = 4
    rng = np.random.default_rng(11)
    e_inc = 10 ** rng.uniform(3, 6, b)
    ode = {"method": "rk4", "options": {"step_size": 0.25}}
    jshape, ps, shape = _tiny_pair(rng, condition_dim=L + 1)
    jenergy = JaxCFM(JaxParallelTransformer(_energy_param()), shape=[L], odeint_kwargs=ode)
    key = jax.random.PRNGKey(3)
    pe = _perturbed(jenergy.init_params(key), rng, 0.05)
    energy = CFM(ParallelTransformer(_energy_param()), shape=[L], odeint_kwargs=ode)
    energy.net.load_state_dict(convert_energy_params(pe))
    gen = Generator(shape, energy, energy_tf, shape_tf, batch=b)
    assert gen.cond_dim == 1

    cond = gen.condition(e_inc)
    shower_j, cond_j = jax.jit(jax_make_fused_generate(jshape, jenergy, jenergy_tf, jshape_tf))(
        ps, pe, jnp.asarray(cond), key)
    k_u, k_s = jax.random.split(key)
    noise = (torch.from_numpy(np.array(jax.random.normal(k_u, (b, L), jnp.float32))),
             torch.from_numpy(np.array(jax.random.normal(k_s, jshape.x_shape(b), jnp.float32))))
    shower_t, cond_t = gen.generate(cond, noise=noise)
    np.testing.assert_allclose(cond_t.numpy(), np.asarray(cond_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(shower_t.numpy(), np.asarray(shower_j), atol=1e-4, rtol=1e-4)

    mev_t = gen.sample_showers(e_inc, noise=noise)
    samples, conds = np.asarray(shower_j)[:, 0], np.asarray(cond_j)
    for fn in jshape_tf[::-1]:
        samples, conds = fn(samples, conds, rev=True)
    assert mev_t.shape == (b, L * A * R) and np.isfinite(mev_t).all() and (mev_t >= 0).all()
    np.testing.assert_allclose(mev_t, samples, rtol=1e-3, atol=1e-3 * samples.max())


def test_compose_and_instantiate_ds2_cinn_config():
    """calochallenge/cinn/calochallenge_ds2_noise builds the port's classes
    at the shipped size: 20 coupling blocks, 40 ViT1D subnets of 135 tokens
    x 24 emitting 31 x 24 values per token, 90,719,040 parameters as in
    JAX (the JAX count from jax.eval_shape)."""
    import math
    from pathlib import Path

    from vit4hep_tpu.utils.config import compose as jax_compose
    from vit4hep_tpu.utils.config import instantiate as jax_instantiate
    from vit4hep_tpu_torch.models.bijectors import BinnedRQSCouplingBlock, Permute
    from vit4hep_tpu_torch.models.calochallenge import CaloChallengeCINN
    from vit4hep_tpu_torch.models.vit import ViT1DNet
    from vit4hep_tpu_torch.utils.config import compose, instantiate

    root = Path(__file__).resolve().parent.parent / "configs"
    model = instantiate(compose(str(root), "calochallenge/cinn/calochallenge_ds2_noise",
                                ["data_dir=/nonexistent"])["model"])
    assert isinstance(model, CaloChallengeCINN) and model.num_patches == (15, 2, 9)
    blocks = list(model.net.blocks)
    assert len(blocks) == 40 and all(isinstance(b, Permute) for b in blocks[1::2])
    coupling = blocks[0]
    assert isinstance(coupling, BinnedRQSCouplingBlock) and coupling.fused_spline
    assert isinstance(coupling.subnet1, ViT1DNet) and coupling.n_params == 31
    assert coupling.subnet1.cfg.prod_num_patches == 135 and coupling.subnet1.cfg.patch_dim == 24
    assert coupling.subnet1.final_layer.linear.out_features == 31 * 24
    assert model.condition_dim == 46

    jmodel = jax_instantiate(jax_compose(str(root), "calochallenge/cinn/calochallenge_ds2_noise",
                                         overrides=["data_dir=/nonexistent"]).model)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k), jax.random.PRNGKey(0))
    jcount = sum(math.prod(a.shape) for a in jax.tree.leaves(shapes))
    assert model.param_count() == jcount == 90_719_040


# ---------------------------------------------------------------------------
# K4 on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("b,d", [(5, 300), (3, 128), (2, 7)])
@pytest.mark.parametrize("identity_tails,clamp,bins", BRANCHES + [(False, None, 1),
                                                                  (True, None, 16)])
def test_k4_matches_plain_on_cuda(cuda_device, identity_tails, clamp, bins, b, d):
    """K4 against its plain version on every branch, at row lengths that
    fill, leave ragged and undershoot a CTA. f32 on both sides; the knots
    are summed in another order, so a point at a knot may change bins (the
    spline is C^1 there): 1e-4 of max(1, max |plain|), as chip_smoke.py's
    TOL. Two launches give identical results."""
    y, theta = _spline_inputs(np.random.default_rng(bins + d), b, d, bins, identity_tails)
    y, theta = torch.from_numpy(y).to(cuda_device), torch.from_numpy(theta).to(cuda_device)
    args = (bins, (0.001, 0.001), DOM, identity_tails, clamp)
    before = tfs.INVERSE.launches
    x, ld = tfs.fused_binned_rqs_inverse(y, theta, *args)
    x2, ld2 = tfs.fused_binned_rqs_inverse(y, theta, *args)
    torch.cuda.synchronize()
    assert tfs.INVERSE.launches == before + 2
    x_ref, ld_ref = tfs.inverse_plain(y, theta, *args)
    for out, ref in ((x, x_ref), (ld, ld_ref)):
        scale = max(1.0, ref.abs().max().item())
        assert (out - ref).abs().max().item() <= 1e-4 * scale
    assert torch.equal(x, x2) and torch.equal(ld, ld2)


@pytest.mark.cuda
def test_k4_rejects_bad_arguments_on_cuda(cuda_device):
    y = torch.zeros(2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="theta has shape"):
        tfs.fused_binned_rqs_inverse(y, torch.zeros(2, 8, 30, device=cuda_device), 10)
    with pytest.raises(ValueError, match="bins"):
        tfs.fused_binned_rqs_inverse(y, torch.zeros(2, 8, 52, device=cuda_device), 17)

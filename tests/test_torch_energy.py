"""Port parity of the energy-decoder module (kernel K3) and the energy
transformer against the JAX package.

CPU tests: the same numpy inputs (and, for the nets, the JAX params converted
by vit4hep_tpu_torch.utils.jax_params) go through the JAX function and the
port's counterpart in float32. The JAX Pallas kernel runs in interpret mode,
as the JAX package's own tests run it here. Tolerance atol=2e-5, rtol=1e-5:
the bound tests/test_energy_fused.py holds the JAX kernel to against its own
composed path; both sides are f32 and differ only in summation order.

CUDA tests (marker ``cuda``) hold the hand-written kernel against the plain
version on the card; they skip without one. On the card (no JAX there):
``python -m pytest --noconftest -m cuda tests/test_torch_energy.py``.
"""

import numpy as np
import pytest
import torch

try:  # the JAX reference; the card's machine has no JAX and runs only `-m cuda`
    import jax

    from vit4hep_tpu.models.energy_transformer import ParallelTransformer as JaxParallelTransformer
    from vit4hep_tpu.models.vit import sampling_variant as jax_sampling_variant
    from vit4hep_tpu.ops import fused_energy_decoder as jfed
except ModuleNotFoundError:
    jax = None

from vit4hep_tpu_torch.models.energy_transformer import ParallelTransformer
from vit4hep_tpu_torch.models.vit import sampling_variant
from vit4hep_tpu_torch.ops import fused_energy_decoder as tfed
from vit4hep_tpu_torch.utils.jax_params import convert_energy_params

ATOL, RTOL = 2e-5, 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, 'PyTorch port')")
    return torch.device("cuda")


def _decoder_args(rng, b=5, n=45, dm=64, te=32, fdim=128, hn=96, depth=2):
    def w(*shape, s=0.1):
        return (rng.normal(size=shape) * s).astype(np.float32)

    return [w(b, n, dm, s=1.0), w(b, te, s=1.0), w(b, depth, dm),
            1.0 + w(depth, 3, dm), w(depth, 3, dm),
            w(depth, dm, 3 * dm), w(depth, 3 * dm), w(depth, dm, dm), w(depth, dm),
            w(depth, dm, fdim), w(depth, fdim), w(depth, fdim, dm), w(depth, dm),
            1.0 + w(dm), w(dm), w(te + dm, hn), w(hn), w(hn, 1), w(1)]


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_decoder_plain_matches_jax_reference(activation):
    args = _decoder_args(np.random.default_rng(0))
    ref = jfed._reference(*args, num_heads=4, activation=activation)
    port = tfed.fused_energy_decoder(*map(torch.from_numpy, args), 4, activation, 8)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_decoder_plain_matches_jax_kernel_interpret():
    """B=5 with group 4: the JAX kernel pads the batch to its group."""
    args = _decoder_args(np.random.default_rng(1))
    ref = jfed.fused_energy_decoder(*args, 4, "relu", 4)
    port = tfed.fused_energy_decoder(*map(torch.from_numpy, args), 4, "relu", 4)
    assert port.shape == (5, 45)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def _net_param(embeds, fused, dims_c=1):
    # ds2-energy geometry at a smaller depth (configs/model/cfm/cfm_ds2_energy.yaml)
    return dict(dims_in=45, dims_c=dims_c, dim_embedding=64 if embeds else 80, nhead=4,
                num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=128,
                dropout=0.0, activation="relu", embeds=embeds,
                encode_t_dim=64 if embeds else 32, encode_t_scale=30,
                fused_block=fused, fused_group=4)


def _perturbed(params, rng):
    """Random params everywhere (flax init zeroes biases)."""
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + rng.normal(0, 0.05, a.shape).astype(np.float32),
        params)


@pytest.mark.parametrize("embeds", [True, False])
@pytest.mark.parametrize("fused", [False, "sample"])
@pytest.mark.parametrize("conditional", [True, False])
def test_parallel_transformer_matches_jax(embeds, fused, conditional):
    """Composed nets, and the `fused_block: sample` twin (the decoder kernel
    path), with the JAX params converted into the port."""
    rng = np.random.default_rng(2)
    b = 5
    x = rng.normal(size=(b, 45)).astype(np.float32)
    t = rng.uniform(size=(b, 1)).astype(np.float32)
    c = rng.normal(size=(b, 1)).astype(np.float32) if conditional else None
    jnet = JaxParallelTransformer(_net_param(embeds, fused))
    params = _perturbed(jnet.init(jax.random.PRNGKey(0), x, t, c), rng)
    if fused:
        jnet = jax_sampling_variant(jnet)
    ref = np.asarray(jnet.apply(params, x, t, c))

    net = ParallelTransformer(_net_param(embeds, fused))
    missing, unexpected = net.load_state_dict(convert_energy_params(params), strict=False)
    assert not unexpected
    # without a condition the JAX net has no encoder or condition-embedding
    # params; the port's exist and go unused
    unused = ("transformer.encoder", "c_embed", "pos_embed_c")
    assert not missing if conditional else all(k.startswith(unused) for k in missing)
    net = sampling_variant(net)
    assert net.cfg.fused_block is (True if fused else False)
    with torch.no_grad():
        port = net(torch.from_numpy(x), torch.from_numpy(t),
                   None if c is None else torch.from_numpy(c))
    np.testing.assert_allclose(port.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_fourier_default_matches_jax_constant():
    net = ParallelTransformer(_net_param(True, False))
    w = np.random.default_rng(20260816).normal(size=(32,)) * 30
    np.testing.assert_array_equal(net.time_embed[0].W.numpy(), w.astype(np.float32))


def test_decoder_kernel_rejects_cpu_args_on_cuda_path():
    """The kernel wrapper never takes CPU tensors: it raises, it does not
    fall back to the plain version."""
    args = [torch.from_numpy(a) for a in _decoder_args(np.random.default_rng(3), b=2)]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tfed.energy_decoder_kernel(*args, num_heads=4, activation="relu")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,activation", [
    (dict(b=64, dm=128, te=64, fdim=512, hn=512, depth=4), "relu"),  # ds2
    (dict(b=5, dm=64, te=32, fdim=128, hn=96, depth=2), "gelu"),  # the CPU tests' shapes
    (dict(b=3, n=7, dm=48, te=16, fdim=40, hn=24, depth=1), "silu"),  # N < 16-row block
])
def test_decoder_kernel_matches_plain_on_cuda(cuda_device, shape, activation):
    """The kernel is f32 throughout, so only the summation order differs
    from the plain version: atol 1e-4."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _decoder_args(np.random.default_rng(4), **shape)]
    before = tfed.ENERGY_DECODER.launches
    out = tfed.fused_energy_decoder(*args, 4, activation, 8)
    torch.cuda.synchronize()
    assert tfed.ENERGY_DECODER.launches == before + 1
    ref = tfed._reference(*args, num_heads=4, activation=activation)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)

"""The port's host transforms (vit4hep_tpu_torch.data) against the JAX
package's, on the CPU.

Each ds2 step (and the cINN chain's ``SelectiveUniformNoise``) is built
through each package's ``build_pipeline`` from the same config mapping and
applied forward and reversed to the same numpy inputs. Both sides run the
same numpy operations in the same order (and draw noise from generators
seeded alike), so the results must be bit-identical.
"""

import numpy as np
import pytest

from tests.conftest import make_binning_xml
from vit4hep_tpu.data import xml_handler as jxml
from vit4hep_tpu.data.calochallenge import transforms as jtf
from vit4hep_tpu_torch.data import xml_handler as txml
from vit4hep_tpu_torch.data.calochallenge import transforms as ttf

B, L, A, R = 5, 6, 4, 3
V = L * A * R
XML = "<xml>"  # replaced by the test's binning file

# (step, kwargs, forward input shape, reverse input shape, reverse condition width)
CASES = [
    ("NormalizeByElayer", {"ptype": XML, "xml_file": "electron"}, (V,), (V + L,), 1),
    ("NormalizeByElayer", {"ptype": XML, "xml_file": "electron", "cut": 0.02}, (V,), (V + L,), 1),
    ("ScaleTotalEnergy", {"n_layers": L, "factor": 0.35}, (V + L,), (V + L,), 1),
    ("CutValues", {"cut": 0.3, "n_layers": L}, (V + L,), (V + L,), 1),
    ("ExclusiveLogitTransform", {"delta": 1.0e-6, "rescale": True}, (V + L,), (V + L,), 1),
    ("ExclusiveLogitTransform", {"delta": 0.05, "exclusions": [0, 7]}, (V + L,), (V + L,), 1),
    ("GlobalStandardizeFromFile", {"model_dir": None, "eps": 1.0e-6}, (V + L,), (V + L,), 1),
    ("StandardizeUsFromFile", {"n_us": L, "model_dir": None}, (V + L,), (V + L,), 1),
    ("SelectDims", {"start": -L, "end": 0}, (V + L,), (L,), 1),
    ("LogEnergy", {}, (V,), (V,), 1),
    ("ScaleEnergy", {"e_min": 6.907755, "e_max": 13.815510}, (V,), (V,), 1),
    ("AddFeaturesToCond", {"split_index": V}, (V + L,), (V,), L + 1),
    ("Reshape", {"shape": [1, L, A, R]}, (V,), (1, L, A, R), 1),
]


@pytest.fixture
def run_dir(tmp_path):
    make_binning_xml(tmp_path / "binning.xml", n_layers=L, n_r=R, n_alpha=A)
    rng = np.random.default_rng(11)
    np.save(tmp_path / "means.npy", np.float32(-6.0))
    np.save(tmp_path / "stds.npy", np.float32(3.0))
    np.save(tmp_path / "means_u.npy", rng.normal(0, 0.3, L).astype(np.float32))
    np.save(tmp_path / "stds_u.npy", rng.uniform(0.8, 1.5, L).astype(np.float32))
    return tmp_path


def _resolve(kwargs, run_dir):
    return {k: str(run_dir / "binning.xml") if v == XML else v for k, v in kwargs.items()}


@pytest.mark.parametrize("name,kwargs,fwd_shape,rev_shape,rev_c", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_step_matches_jax(run_dir, name, kwargs, fwd_shape, rev_shape, rev_c):
    cfg = {name: _resolve(kwargs, run_dir)}
    (port,), (ref,) = ttf.build_pipeline(cfg, str(run_dir)), jtf.build_pipeline(cfg, str(run_dir))
    assert type(port).__name__ == type(ref).__name__
    assert hasattr(port, "u_transform") == hasattr(ref, "u_transform")
    assert hasattr(port, "cond_transform") == hasattr(ref, "cond_transform")
    rng = np.random.default_rng(12)
    x_fwd = rng.uniform(0.01, 0.99, (B, *fwd_shape))
    e_inc = 10 ** rng.uniform(3, 6, (B, 1))  # incident energies in MeV
    x_rev = rng.uniform(0.01, 0.99, (B, *rev_shape))
    c_rev = rng.uniform(0.01, 0.99, (B, rev_c))  # a condition in the training basis
    for rev, x, c in ((False, x_fwd, e_inc), (True, x_rev, c_rev)):
        x, c = x.astype(np.float32), c.astype(np.float32)
        x_p, c_p = port(x.copy(), c.copy(), rev=rev)
        x_r, c_r = ref(x.copy(), c.copy(), rev=rev)
        np.testing.assert_array_equal(x_p, x_r)
        np.testing.assert_array_equal(c_p, c_r)


def test_pipeline_round_trip_matches_jax(run_dir):
    """The ds2 shape chain, forward then reversed, as the staged path runs it."""
    cfg = {"NormalizeByElayer": {"ptype": str(run_dir / "binning.xml"), "xml_file": "electron"},
           "ScaleTotalEnergy": {"n_layers": L, "factor": 0.35},
           "CutValues": {"cut": 1.0e-7, "n_layers": L},
           "ExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": True},
           "GlobalStandardizeFromFile": {"model_dir": None, "eps": 1.0e-6},
           "LogEnergy": {}, "ScaleEnergy": {"e_min": 6.907755, "e_max": 13.815510},
           "AddFeaturesToCond": {"split_index": V}, "Reshape": {"shape": [1, L, A, R]}}
    rng = np.random.default_rng(13)
    e_inc = (10 ** rng.uniform(3, 6, (B, 1))).astype(np.float32)
    showers = rng.exponential(1.0, (B, V)).astype(np.float32) * e_inc / V
    port, ref = ttf.build_pipeline(cfg, str(run_dir)), jtf.build_pipeline(cfg, str(run_dir))
    x_p, c_p = ttf.apply_pipeline(port, showers, e_inc)
    x_r, c_r = jtf.apply_pipeline(ref, showers, e_inc)
    np.testing.assert_array_equal(x_p, x_r)
    np.testing.assert_array_equal(c_p, c_r)
    back_p, e_p = ttf.apply_pipeline(port, x_p, c_p, rev=True)
    back_r, e_r = jtf.apply_pipeline(ref, x_r, c_r, rev=True)
    np.testing.assert_array_equal(back_p, back_r)
    np.testing.assert_array_equal(e_p, e_r)
    # and the chain inverts: float32 logit/exp round trip, 1e-3 relative
    np.testing.assert_allclose(back_p, showers, rtol=1e-3, atol=1e-3 * showers.max())


@pytest.mark.parametrize("cut,exclusions", [(True, list(range(-L, 0))), (False, None),
                                             (True, [0, 3])])
def test_selective_uniform_noise_matches_jax(cut, exclusions):
    """The reverse (a threshold cut sparing the exclusions) bit-identical;
    the forward draws the same noise from the same seed: the JAX package's
    module-level generator, the port's explicit one."""
    kwargs = {"a": 1.0e-7, "b": 1.0e-6, "cut": cut, "exclusions": exclusions}
    (port,), (ref,) = (ttf.build_pipeline({"SelectiveUniformNoise": kwargs}, "."),
                       jtf.build_pipeline({"SelectiveUniformNoise": kwargs}, "."))
    assert not hasattr(port, "u_transform") and not hasattr(ref, "u_transform")
    rng = np.random.default_rng(14)
    x = rng.uniform(0, 2e-6, (B, V + L)).astype(np.float32)
    x[:, 5] = 1.0  # values equal to 1 take no noise
    c = rng.uniform(size=(B, 1)).astype(np.float32)
    x_p, c_p = port(x.copy(), c.copy(), rev=True)
    x_r, c_r = ref(x.copy(), c.copy(), rev=True)
    np.testing.assert_array_equal(x_p, x_r)
    np.testing.assert_array_equal(c_p, c_r)
    jtf.seed_transforms(15)
    port.rng = np.random.default_rng(15)
    np.testing.assert_array_equal(port(x.copy(), c)[0], ref(x.copy(), c)[0])


def test_cinn_ds2_pipeline_matches_jax(run_dir):
    """The shape chain of calochallenge/cinn/calochallenge_ds2_noise,
    forward (with the same noise seed) and reversed."""
    cfg = {"NormalizeByElayer": {"ptype": str(run_dir / "binning.xml"), "xml_file": "electron"},
           "ScaleTotalEnergy": {"n_layers": L, "factor": 0.35},
           "SelectiveUniformNoise": {"a": 1.0e-7, "b": 1.0e-6, "cut": True,
                                     "exclusions": list(range(-L, 0))},
           "ExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": True},
           "GlobalStandardizeFromFile": {"model_dir": None},
           "LogEnergy": {}, "ScaleEnergy": {"e_min": 6.907755, "e_max": 13.815510},
           "AddFeaturesToCond": {"split_index": V}, "Reshape": {"shape": [1, L, A, R]}}
    rng = np.random.default_rng(16)
    e_inc = (10 ** rng.uniform(3, 6, (B, 1))).astype(np.float32)
    showers = (rng.exponential(1.0, (B, V)) * (rng.random((B, V)) > 0.4)).astype(np.float32)
    showers *= e_inc / V
    port, ref = ttf.build_pipeline(cfg, str(run_dir)), jtf.build_pipeline(cfg, str(run_dir))
    jtf.seed_transforms(17)
    port[2].rng = np.random.default_rng(17)
    x_p, c_p = ttf.apply_pipeline(port, showers, e_inc)
    x_r, c_r = jtf.apply_pipeline(ref, showers, e_inc)
    np.testing.assert_array_equal(x_p, x_r)
    np.testing.assert_array_equal(c_p, c_r)
    back_p, e_p = ttf.apply_pipeline(port, x_p, c_p, rev=True)
    back_r, e_r = jtf.apply_pipeline(ref, x_r, c_r, rev=True)
    np.testing.assert_array_equal(back_p, back_r)
    np.testing.assert_array_equal(e_p, e_r)


def test_xml_handler_matches_jax(tmp_path):
    """Irregular layers: different radial and alpha binnings per layer."""
    layers = [("0,5,10", 1), ("0,2,4,8,16", 10), ("0,3", 4), ("0,1,2,3,4,5", 16)]
    body = [f'    <Layer id="{i}" r_edges="{r}" n_bin_alpha="{a}"/>' for i, (r, a) in
            enumerate(layers)]
    path = tmp_path / "irregular.xml"
    path.write_text("\n".join(["<Bins>", '  <Particle name="pion">', *body, "  </Particle>",
                               '  <Particle name="photon">', body[0], "  </Particle>", "</Bins>"]))
    port, ref = txml.XMLHandler("pion", str(path)), jxml.XMLHandler("pion", str(path))
    np.testing.assert_array_equal(port.GetBinEdges(), ref.GetBinEdges())
    assert port.GetTotalNumberOfBins() == ref.GetTotalNumberOfBins() == 2 + 40 + 4 + 80
    with pytest.raises(ValueError, match="not found"):
        txml.XMLHandler("electron", str(path))


def test_unported_steps_and_missing_statistics_raise(run_dir, tmp_path_factory):
    with pytest.raises(NotImplementedError, match="AddAngularBins"):
        ttf.build_pipeline({"AddAngularBins": {}}, str(run_dir))
    # no statistics yet: the step builds (a forward call fits them), and
    # reversing before that raises
    empty = tmp_path_factory.mktemp("untrained")
    (step,) = ttf.build_pipeline({"StandardizeUsFromFile": {"n_us": L, "model_dir": None}},
                                 str(empty))
    with pytest.raises(FileNotFoundError, match="training"):
        step(np.zeros((2, V + L), np.float32), np.ones((2, 1), np.float32), rev=True)

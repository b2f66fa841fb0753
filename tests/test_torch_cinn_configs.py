"""Every shipped cINN config in the port, on the CPU: the eight shape-cINN
configs under ``configs/model/cinn/`` and ``cinn_energy.yaml`` build (at
full size on the meta device, with JAX's parameter count where no other
test holds it), train a step and sample (cut to 2 blocks at the full
widths); and the new config dicts of ``chip_smoke.py`` equal their YAML.
"""

import importlib.util
import math
from pathlib import Path

import jax
import pytest
import torch
import yaml

from vit4hep_tpu.utils.config import compose as jax_compose
from vit4hep_tpu.utils.config import instantiate as jax_instantiate

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def one_thread():
    """torch on one thread for a test: the full-width steps below are many
    small ops, which torch's thread pool slows down many times over when
    the test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPE_CONFIGS = ["cinn_ds1_photons", "cinn_ds1_pions", "cinn_ds2_electrons",
                 "cinn_ds2_electrons_tpu", "cinn_ds3_electrons", "cinn_nflows",
                 "cinn_nflows_ds3", "cinn_nflows_oneside"]
# the configs whose full parameter count other tests hold against JAX:
# tests/test_torch_ds1.py, test_torch_cinn.py, test_torch_vit_rest.py and
# test_torch_chain.py
COUNTED_ELSEWHERE = {"cinn_ds1_photons", "cinn_ds1_pions", "cinn_ds2_electrons",
                     "cinn_ds2_electrons_tpu", "cinn_ds3_electrons"}


def _compose(model):
    """The cINN experiment composed with ``model``; the energy cINN through
    calochallenge_ds2_energy."""
    from vit4hep_tpu_torch.utils.config import compose

    name = ("calochallenge/cfm/calochallenge_ds2_energy" if model == "cinn_energy"
            else "calochallenge/cinn/calochallenge_ds2_noise")
    overrides = [f"model=cinn/{model}", "data_dir=/nonexistent"]
    return (compose(str(ROOT / "configs"), name, overrides),
            jax_compose(str(ROOT / "configs"), name, overrides=overrides))


@pytest.mark.parametrize("model", SHAPE_CONFIGS + ["cinn_energy"])
def test_shipped_cinn_config_builds_trains_and_samples(model, one_thread):
    """Each shipped cINN model config: at full size (built on the meta
    device) the port's classes, with JAX's parameter count (jax.eval_shape)
    for the configs no other test counts (COUNTED_ELSEWHERE); cut to 2
    blocks of depth-1 subnets at the full widths and token counts, one AdamW
    step of the launcher's train step on a batch of 2 (finite loss and
    gradient norm, the parameters moved) and a sample of 2 (finite, of the
    x shape)."""
    from vit4hep_tpu_torch.experiments import train_state as ts
    from vit4hep_tpu_torch.models.calochallenge import (CaloChallengeCINN,
                                                        CaloChallengeEnergyCINN)
    from vit4hep_tpu_torch.utils.config import instantiate

    cfg, jcfg = _compose(model)
    with torch.device("meta"):
        full = instantiate(cfg["model"])
    if model not in COUNTED_ELSEWHERE:
        jmodel = jax_instantiate(jcfg.model)
        shapes = jax.eval_shape(lambda k: jmodel.init_params(k), jax.random.PRNGKey(0))
        assert full.param_count() == sum(math.prod(a.shape) for a in jax.tree.leaves(shapes))
    assert isinstance(full, CaloChallengeEnergyCINN if model == "cinn_energy"
                      else CaloChallengeCINN)

    small = cfg["model"].to_container(resolve=True)
    small["nblocks"] = 2
    if "is_spatial" in small:
        small["is_spatial"] = small["is_spatial"][-2:]  # a spatial block where the config has one
        small["vit_kwargs"]["depth"] = 1
    torch.manual_seed(0)
    net = instantiate(small)
    with torch.no_grad():  # non-zero output layers, so the couplings act
        for p in net.parameters():
            p.add_(0.01 * torch.randn_like(p))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(net.x_shape(2), generator=gen) * 0.5
    c = torch.rand((2, net.condition_dim), generator=gen)
    state = ts.create_train_state(net, cfg["training"], use_ema=True)
    before = [p.detach().clone() for p in state.params]
    step = ts.make_train_step(lambda x, c: net.batch_loss(x, c), clip_grad_norm=1000,
                              ema_decay=0.9999)
    m = step(state, (x, c))
    assert math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"]))
    assert not m["skipped"] and any(not torch.equal(a, b) for a, b in zip(before, state.params))
    sample = net.sample_batch(c, generator=gen)
    assert sample.shape == net.x_shape(2) and torch.isfinite(sample).all()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_cinn_rest_configs_equal_yaml():
    """The smoke's new dicts are the shipped YAML: the nflows cINNs, the
    energy cINN and the cINN training config (training/default.yaml with
    cinn/ds23.yaml on top)."""
    smoke = _chip_smoke()
    load = lambda rel: yaml.safe_load((ROOT / "configs" / rel).read_text())  # noqa: E731
    for rel, want in (("model/cinn/cinn_nflows.yaml", smoke.NFLOWS_MODEL),
                      ("model/cinn/cinn_nflows_oneside.yaml", smoke.NFLOWS_ONESIDE_MODEL),
                      ("model/cinn/cinn_nflows_ds3.yaml", smoke.NFLOWS_DS3_MODEL),
                      ("model/cinn/cinn_energy.yaml", smoke.ENERGY_CINN_MODEL)):
        assert want == load(rel), rel
    training = {k: v for k, v in load("training/default.yaml").items() if k != "defaults"}
    training.update({k: v for k, v in load("training/cinn/ds23.yaml").items()
                     if k != "defaults"})
    for key in ("eps", "lr"):  # YAML 1.1 reads 1e-8 and 1e-4 as strings
        training[key] = float(training[key])
    assert smoke.CINN_TRAINING == training

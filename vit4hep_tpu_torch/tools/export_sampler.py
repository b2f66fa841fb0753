"""Export a trained run as a self-contained serving artifact (the port's
twin of the root ``tools/export_sampler.py``; ``utils/serving.py``).

    python -m vit4hep_tpu_torch.tools.export_sampler -cp runs/<exp>/<run> \\
        [-cn config] [--idx N] [--no-ema] [--batch 1024] [--out FILE] \\
        [--device cuda|cpu] [overrides...]

Reads the run's config and its ``models/model_run<idx>.pt`` (the port's
checkpoint, or a reference run's, migrated; the EMA weights when the run
used EMA, unless ``--no-ema``), and writes ``<run_dir>/sampler.v4h``: the
model's ``sample_batch``, or, when the run names an energy model
(``energy_model``), ``generator.v4h``, the whole two-stage chain behind
that energy run. The chain's condition layout (``u_position``,
``energy_cond_width``) is the family's experiment's, as its ``sample_n``
composes it, for every family. The run is built through the port's
experiment of its ``exp_type``; composing the config needs PyYAML, so run
it on a host that has it, on the device the artifact will serve on. Serve
with::

    from vit4hep_tpu_torch.utils.serving import load_sampler
    sampler = load_sampler("generator.v4h")
    showers = sampler(cond, seed=0)   # cond: (batch, cond_dim) float32
"""

from __future__ import annotations

import argparse
import os
import re

import torch


def _latest(run_dir) -> int:
    runs = [int(m.group(1)) for name in os.listdir(os.path.join(run_dir, "models"))
            if (m := re.fullmatch(r"model_run(\d+)\.pt", name))]
    if not runs:
        raise SystemExit(f"no checkpoints under {run_dir}/models")
    return max(runs)


def load_run(run_dir, config_name="config", overrides=(), idx=None, ema=True, device="cuda"):
    """The experiment of a run dir with its model loaded from
    ``model_run<idx>.pt`` (the highest by default) in eval mode, its
    transforms built from the run's statistics: (experiment, metadata)."""
    from vit4hep_tpu_torch.experiments.main import get_experiment
    from vit4hep_tpu_torch.utils import torch_migration as tm
    from vit4hep_tpu_torch.utils.checkpoint import load_checkpoint
    from vit4hep_tpu_torch.utils.config import compose, instantiate

    run_dir = os.path.abspath(run_dir)
    cfg = compose(run_dir, config_name, list(overrides))
    cfg.run_dir = run_dir
    idx = _latest(run_dir) if idx is None else int(idx)
    payload = load_checkpoint(os.path.join(run_dir, "models", f"model_run{idx}.pt"))
    use_ema = bool(cfg.get("ema", False)) and ema
    exp = get_experiment(cfg.exp_type)(cfg, device=device)
    exp.seed = int(cfg.get("seed") or 0)
    if "training_file_dict" in cfg.data:  # a lazy family fits its warm-up steps on them
        exp.hdf5_dict_train = {k: list(v) for k, v in cfg.data.training_file_dict.items()}
    exp.transforms = exp.build_transforms(cfg.data.transforms, run_dir)
    if tm.is_reference_checkpoint(payload):
        net_sd, ema_sd = tm.convert_reference_checkpoint(cfg.model, payload)
        exp.model = instantiate(cfg.model)
        exp.model.net.load_state_dict(ema_sd if use_ema and ema_sd is not None else net_sd)
    else:
        exp.model = instantiate(cfg.model)
        exp.model.load_state_dict(payload["model"])
        if use_ema and payload.get("ema") is not None:
            with torch.no_grad():
                params = [p for p in exp.model.parameters() if p.requires_grad]
                for p, e in zip(params, payload["ema"], strict=True):
                    p.copy_(e)
    exp.model = exp.model.to(exp.device).eval()
    meta = {"run_dir": run_dir, "checkpoint": f"model_run{idx}", "ema": use_ema,
            "exp_name": cfg.get("exp_name"), "exp_type": cfg.exp_type}
    return exp, meta


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-cp", dest="config_path", required=True,
                    help="run dir holding config.yaml and models/")
    ap.add_argument("-cn", dest="config_name", default="config")
    ap.add_argument("--idx", type=int, default=None,
                    help="checkpoint index (default: the run's highest)")
    ap.add_argument("--no-ema", action="store_true",
                    help="export the raw weights even when the run used EMA")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--out", default=None,
                    help="output file (default <run_dir>/sampler.v4h, or generator.v4h for a "
                         "run that names an energy model)")
    ap.add_argument("--device", default="cuda", help="device to export on (default cuda)")
    ap.add_argument("overrides", nargs="*", help="dotted config overrides")
    arg = ap.parse_args(argv)

    from vit4hep_tpu_torch.utils.serving import save_generator, save_sampler

    exp, meta = load_run(arg.config_path, arg.config_name, arg.overrides, arg.idx,
                         not arg.no_ema, arg.device)
    cfg = exp.cfg
    if cfg.get("energy_model") and cfg.get("model_type", "shape") == "shape":
        exp.load_energy_model()
        out = arg.out or os.path.join(meta["run_dir"], "generator.v4h")
        header = save_generator(out, exp.model, exp.energy_model, exp.energy_model_transforms,
                                exp.transforms, arg.batch, u_position=exp.u_position,
                                energy_cond_width=exp.energy_cond_width,
                                meta=dict(meta, energy_run=str(cfg.energy_model)))
    else:
        out = arg.out or os.path.join(meta["run_dir"], "sampler.v4h")
        header = save_sampler(out, exp.model, arg.batch, meta=meta)
    print(f"wrote {out}: {header['model']} batch={header['batch']} cond_dim={header['cond_dim']} "
          f"out={header['out_shape']} platforms={header['platforms']} ema={meta['ema']}")
    return header


if __name__ == "__main__":
    main()

"""Experiment lifecycle on one device: run management, the training loop,
checkpoints (port of ``vit4hep_tpu/experiments/base.py``).

Keeps the template-method surface of the JAX ``BaseExperiment``: subclasses
implement ``init_data``, ``_init_dataloader``, ``val_batches``, ``evaluate``
and ``plot``. The run directory layout is the reference's:
``<base_dir>/runs/<exp_name>/<run_name>/`` with ``config.yaml``,
``config_<idx>.yaml``, ``out_<idx>.log`` and ``models/model_run<idx>.pt``,
so ``-cp runs/... -cn config warm_start_idx=K`` resumes a run as run K + 1.

The JAX package's device mesh, multi-process logic and torch-checkpoint
migration reduce to one device here: the model and the batches live on
``device`` (``"cuda"`` unless the caller asks for ``"cpu"``; without CUDA
the experiment raises). The step itself is
``experiments/train_state.make_train_step``.
"""

from __future__ import annotations

import os
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

from vit4hep_tpu_torch.experiments import train_state as ts
from vit4hep_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from vit4hep_tpu_torch.utils.config import MissingMandatoryValue, instantiate
from vit4hep_tpu_torch.utils.logger import LOGGER, flush_buffered_logs, init_logging
from vit4hep_tpu_torch.utils.misc import count_parameters, flatten_dict, get_dtype
from vit4hep_tpu_torch.utils.tracking import Tracker


def resolve_device(device) -> torch.device:
    """The experiment's device; CUDA unless the caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the experiment runs on a CUDA device and none is available; "
                           "pass device='cpu' to run on the CPU")
    return device


class BaseExperiment:
    def __init__(self, cfg, rank=0, world_size=1, device="cuda"):
        if world_size != 1:
            raise NotImplementedError("multi-process training is not ported yet (ROADMAP.md "
                                      "queue 1, the parallel layer)")
        self.cfg = cfg
        self.rank = rank
        self.world_size = world_size
        self.device = resolve_device(device)
        self.tracker = None

    def __call__(self):
        try:
            self.run_tracked()
        except MissingMandatoryValue:
            LOGGER.exception("Tried to access key that is not specified in the config files")
            raise
        except Exception:
            LOGGER.exception("Exiting with error")
            raise
        finally:
            flush_buffered_logs()

    def run_tracked(self):
        run_name = self._init()
        LOGGER.info(f"### Starting experiment {self.cfg.exp_name}/{run_name} "
                    f"(jobid={self.cfg.get('jobid')}) ###")
        try:
            self.full_run()
        finally:
            if self.tracker is not None:
                self.tracker.close()

    # ------------------------------------------------------------------ setup
    def _init(self):
        run_name = self._init_experiment()
        self._init_directory()
        if self.cfg.use_mlflow:
            self.tracker = Tracker(
                str(Path(self.cfg.base_dir) / "runs" / self.cfg.exp_name / "tracking"),
                self.cfg.exp_name, run_name)
        init_logging(self.cfg.run_dir if self.cfg.save else None, run_idx=self.cfg.run_idx,
                     debug=self.cfg.get("debug", False))
        self._init_backend()
        return run_name

    def _init_experiment(self):
        self.warm_start = self.cfg.get("warm_start_idx") is not None
        if not self.warm_start:
            run_name = self.cfg.get("run_name")
            if run_name is None:
                run_name = f"{self.cfg.exp_type}_{np.random.randint(0, 99999):05}"
            run_dir = os.path.join(self.cfg.base_dir, "runs", self.cfg.exp_name, run_name)
            run_idx = 0
            LOGGER.info(f"Creating new experiment {self.cfg.exp_name}/{run_name}")
        else:
            run_name = self.cfg.run_name
            run_idx = self.cfg.run_idx + 1
            LOGGER.info(f"Warm-starting from existing experiment "
                        f"{self.cfg.exp_name}/{run_name} for run {run_idx}")
        self.cfg.run_idx = run_idx
        if not self.warm_start:
            self.cfg.warm_start_idx = 0
            self.cfg.run_name = run_name
            self.cfg.run_dir = run_dir
        self.cfg.use_mlflow = False if not self.cfg.save else self.cfg.use_mlflow

        seed = self.cfg.get("seed")
        if seed is not None:
            LOGGER.info(f"Using seed {seed}")
            np.random.seed(seed)
        self.seed = int(seed) if seed is not None else int(np.random.randint(2**31))
        torch.manual_seed(self.seed)
        return run_name

    def _init_directory(self):
        if not self.cfg.save:
            LOGGER.info("Running with save=False, i.e. no outputs will be saved")
            return
        run_dir = Path(self.cfg.run_dir).resolve()
        if run_dir.exists() and not self.warm_start:
            raise ValueError(f"Experiment in directory {self.cfg.run_dir} already exists. "
                             "Aborting.")
        os.makedirs(run_dir / "models", exist_ok=True)
        if self.cfg.get("save_source", False):
            pkg_root = Path(__file__).resolve().parents[1]
            with zipfile.ZipFile(run_dir / "source.zip", "w", zipfile.ZIP_DEFLATED) as zf:
                for path in pkg_root.rglob("*.py"):
                    zf.write(path, path.relative_to(pkg_root.parent))

    def _init_backend(self):
        self.dtype = get_dtype(self.cfg.get("dtype", "float32"))
        if self.dtype != torch.float32:
            raise NotImplementedError("the port trains in float32 (compute_dtype float32)")
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        LOGGER.info(f"Using device {self.device} ({name}), dtype {self.dtype}")
        if self.cfg.get("debug", False):
            torch.autograd.set_detect_anomaly(True)
            LOGGER.info("debug: autograd anomaly detection enabled")

    def _log(self, key, value, step=0, kind="metric"):
        if self.tracker is not None:
            self.tracker.log(key, value, step=step, kind=kind)

    # ------------------------------------------------------------------ run
    def full_run(self):
        t0 = time.time()
        self.init_physics()
        self.init_model()
        self.init_data()
        self._init_dataloader()
        self._init_loss()
        if self.cfg.save:
            self._save_config("config.yaml", to_tracker=True)
            self._save_config(f"config_{self.cfg.run_idx}.yaml")
        # the state (and a warm start's restore) exists outside the train
        # branch, so `train=false warm_start_idx=K` can evaluate a run
        self._init_optimizer()
        if self.cfg.train:
            self._init_scheduler()
            self.train()
            self._save_model()
            if self.cfg.save and self.cfg.get("plotting", {}) and \
                    self.cfg.plotting.get("loss", False):
                self._plot_training_curves()
        if self.cfg.evaluate:
            self.evaluate()
        if self.cfg.plot and self.cfg.save:
            self.plot()
        if self.cfg.get("load_sample"):
            self.eval_sample(self.cfg.load_sample)
        if self.device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(self.device) / 2**30
            LOGGER.info(f"Peak device memory: {peak:.3f} GiB")
            self._log("peak_memory_gib", peak)
        dt = time.time() - t0
        LOGGER.info(f"Finished experiment {self.cfg.exp_name}/{self.cfg.run_name} "
                    f"after {dt / 60:.2f}min = {dt / 60**2:.2f}h")

    # ------------------------------------------------------------------ model
    def init_model(self):
        self.model = instantiate(self.cfg.model).to(self.device)
        self.use_ema = bool(self.cfg.get("ema", False))
        LOGGER.info("Using EMA for validation and eval" if self.use_ema else "Not using EMA")
        num_parameters = count_parameters(self.model)
        self._log("num_parameters", float(num_parameters))
        LOGGER.info(f"Instantiated model {type(self.model.net).__name__} "
                    f"with {num_parameters} learnable parameters")

    def _init_optimizer(self):
        self.state = ts.create_train_state(self.model, self.cfg.training, self.use_ema)
        self.lr_schedule = ts.make_schedule(self.cfg.training)
        if self.warm_start:
            path = self._model_path(f"model_run{self.cfg.warm_start_idx}")
            LOGGER.info(f"Loading model/optimizer/EMA state from {path}")
            load_checkpoint(path, self.state)

    def _init_scheduler(self):
        # schedules live in the train state; ReduceLROnPlateau is host-driven
        self.plateau = None
        if self.cfg.training.get("scheduler") == "ReduceLROnPlateau":
            self.plateau = {
                "factor": float(self.cfg.training.get("reduceplateau_factor", 0.1)),
                "patience": int(self.cfg.training.get("reduceplateau_patience", 10)),
                "best": float("inf"),
                "bad": 0,
            }

    # ------------------------------------------------------------------ train
    def _batch(self, batch):
        return tuple(torch.as_tensor(a, device=self.device) for a in batch)

    def loss(self, x, c):
        """The training objective of one batch; the draws come from the
        experiment's generator on its device."""
        return self.model.batch_loss(x, c, generator=self._rng)

    def _make_steps(self):
        tcfg = self.cfg.training
        self._rng = torch.Generator(device=self.device).manual_seed(self.seed)
        self._train_step = ts.make_train_step(
            self.loss,
            clip_grad_value=tcfg.get("clip_grad_value"),
            clip_grad_norm=tcfg.get("clip_grad_norm"),
            max_grad_norm=tcfg.get("max_grad_norm"),
            ema_decay=float(tcfg.get("ema_decay", 0.9999)) if self.use_ema else None,
        )

    def train(self):
        self.train_lr, self.train_loss, self.val_loss = [], [], []
        self.grad_norm_train, self.grad_norm_net, self.skipped = [], [], []
        self.step_times = []  # host seconds per step (each ends in a device sync)
        self.fetch_times = []  # host seconds per step waiting for its batch
        self._make_steps()
        smallest_val_loss, smallest_val_loss_step, patience = 1e10, 0, 0
        tcfg = self.cfg.training
        iterations = int(tcfg.iterations)
        validate_every = int(tcfg.validate_every_n_steps)
        log_every = int(tcfg.get("log_every_n_steps", 0) or 0)
        LOGGER.info(f"Starting to train for {iterations} iterations "
                    f"= {iterations / self.batches_per_epoch:.1f} epochs "
                    f"on a dataset with {self.batches_per_epoch} batches "
                    f"using early stopping with patience {tcfg.es_patience} "
                    f"while validating every {validate_every} iterations")
        self.training_start_time = time.time()
        train_time, val_time = 0.0, 0.0
        # optional profiler window: steps [10, 20) into <run_dir>/profile
        profile_window = (10, 20) if self.cfg.get("profile", False) and self.cfg.save else None
        prof = None

        self.model.train()
        step = 0
        for step in range(iterations):
            if profile_window and step == profile_window[0]:
                prof = self._start_profile()
            t_fetch = time.time()
            data = self._batch(next(self.train_iterator))
            t0 = time.time()
            self.fetch_times.append(t0 - t_fetch)
            lr = self.state.lr()
            metrics = self._train_step(self.state, data)
            self._record(step, lr, metrics, log_every)
            self.step_times.append(time.time() - t0)
            train_time += self.step_times[-1]
            if prof is not None and step == profile_window[1] - 1:
                prof = self._stop_profile(prof)

            validating = (step + 1) % validate_every == 0
            if validating:
                t0 = time.time()
                val_loss = self._validate(step)
                val_time += time.time() - t0
                if val_loss < smallest_val_loss:
                    smallest_val_loss, smallest_val_loss_step, patience = val_loss, step, 0
                    if tcfg.get("es_load_best_model", False):
                        self._save_model(f"model_run{self.cfg.run_idx}_it{step}")
                else:
                    patience += 1
                    if patience > int(tcfg.es_patience):
                        LOGGER.info(f"Early stopping in iteration {step} "
                                    f"= epoch {step / self.batches_per_epoch:.1f}")
                        break
                self._plateau_step(val_loss)

            if step in (0, 9, 999) or validating:
                dt = time.time() - self.training_start_time
                dt_estimate = dt * iterations / (step + 1)
                loss_str = (f", val loss {val_loss:.5f}" if validating
                            else f", train loss {self.train_loss[-1]:.5f}")
                LOGGER.info(f"Finished iteration {step + 1} after {dt:.2f}s, "
                            f"training time estimate: {dt_estimate / 60:.2f}min "
                            f"= {dt_estimate / 60**2:.2f}h{loss_str}")
        if prof is not None:  # the loop ended inside the window
            self._stop_profile(prof)

        dt = time.time() - self.training_start_time
        self.train_seconds = dt  # the whole loop: batches, steps, validations, checkpoints
        LOGGER.info(f"Finished training for {step} iterations "
                    f"= {step / self.batches_per_epoch:.1f} epochs "
                    f"after {dt / 60:.2f}min = {dt / 60**2:.2f}h")
        LOGGER.info(f"Spend {train_time:.2f}s training and {val_time:.2f}s validating")
        self._log("iterations", step)
        self._log("epochs", step / self.batches_per_epoch)
        self._log("traintime", dt / 3600)
        if tcfg.get("es_load_best_model", False):
            path = self._model_path(f"model_run{self.cfg.run_idx}_it{smallest_val_loss_step}")
            try:
                load_checkpoint(path, self.state)
                LOGGER.info(f"Loading model from {path}")
            except FileNotFoundError:
                LOGGER.warning(f"Cannot load best model (it {smallest_val_loss_step}) "
                               f"from {path}")

    def _record(self, step, lr, metrics, log_every):
        loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
        if metrics["skipped"]:
            LOGGER.warning(f"Skipped update at step {step} (grad norm {grad_norm:.3g})")
        self.train_loss.append(loss)
        self.train_lr.append(lr)
        self.grad_norm_train.append(grad_norm)
        self.grad_norm_net.append(float(metrics["grad_norm_net"]))
        self.skipped.append(metrics["skipped"])
        if log_every and step % log_every == 0:
            for key, value in {"loss": loss, "lr": lr, "grad_norm": grad_norm,
                               "grad_norm_net": self.grad_norm_net[-1],
                               "time_per_step": (time.time() - self.training_start_time)
                               / (step + 1)}.items():
                self._log(f"train.{key}", value, step=step)

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        out = Path(self.cfg.run_dir) / "profile"
        out.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(out / f"trace_run{self.cfg.run_idx}.json"))
        LOGGER.info(f"Saved profiler trace to {out}")
        return None

    def _plateau_step(self, val_loss):
        if self.plateau is None:
            return
        # torch ReduceLROnPlateau's default: improvement only counts below
        # best * (1 - 1e-4)
        if val_loss < self.plateau["best"] * (1.0 - 1e-4):
            self.plateau["best"], self.plateau["bad"] = val_loss, 0
        else:
            self.plateau["bad"] += 1
            if self.plateau["bad"] > self.plateau["patience"]:
                self.state.lr_scale *= self.plateau["factor"]
                self.plateau["bad"] = 0
                LOGGER.info(f"ReduceLROnPlateau: lr scale -> {self.state.lr_scale:.3g}")

    def _validate(self, step):
        """Mean loss over the validation batches, on the EMA parameters when
        ``ema`` is on, without gradients."""
        val_rng = torch.Generator(device=self.device).manual_seed(self.seed + 1 + step)
        losses = []
        with self.eval_params(), torch.no_grad():
            for batch in self.val_batches():
                x, c = self._batch(batch)
                losses.append(self.model.batch_loss(x, c, generator=val_rng))
        val_loss = float(torch.stack(losses).mean())
        self.val_loss.append(val_loss)
        self._log("val.loss", val_loss, step=step)
        return val_loss

    def eval_params(self):
        """A context in which the model holds the EMA parameters when EMA is
        on (the reference's ``ema.average_parameters()``)."""
        return _SwappedParams(self.state.params, self.state.ema if self.use_ema else None)

    # ------------------------------------------------------------------ io
    def _model_path(self, filename):
        return os.path.join(self.cfg.run_dir, "models", f"{filename}.pt")

    def _save_config(self, filename, to_tracker=False):
        if not self.cfg.save:
            return
        with open(Path(self.cfg.run_dir) / filename, "w", encoding="utf-8") as f:
            f.write(self.cfg.to_yaml())
        if to_tracker:
            for key, value in flatten_dict(self.cfg.to_container(resolve=False)).items():
                self._log(key, value, kind="param")

    def _plot_training_curves(self):
        from vit4hep_tpu_torch.utils.base_plots import plot_loss, plot_metric

        run_dir = Path(self.cfg.run_dir)
        idx = self.cfg.run_idx
        if self.train_loss:
            plot_loss(run_dir / f"loss_{idx}.pdf", self.train_loss, self.val_loss,
                      val_every=int(self.cfg.training.validate_every_n_steps))
        if self.train_lr:
            plot_metric(run_dir / f"lr_{idx}.pdf", self.train_lr, "learning rate", logy=True)
        if self.grad_norm_train:
            plot_metric(run_dir / f"grad_norm_{idx}.pdf", self.grad_norm_train,
                        "gradient norm", logy=True)

    def _save_model(self, filename=None):
        if not self.cfg.save:
            return
        save_checkpoint(self._model_path(filename or f"model_run{self.cfg.run_idx}"), self.state)

    # ------------------------------------------------------------------ abstract
    def init_physics(self):
        raise NotImplementedError

    def init_data(self):
        raise NotImplementedError

    def evaluate(self):
        raise NotImplementedError

    def plot(self):
        raise NotImplementedError

    def eval_sample(self, dirname=""):
        raise NotImplementedError

    def _init_dataloader(self):
        raise NotImplementedError

    def _init_loss(self):
        raise NotImplementedError

    def val_batches(self):
        raise NotImplementedError


class _SwappedParams:
    """Swap ``shadow`` into ``params`` for the duration of a ``with`` block
    (nothing to do when ``shadow`` is None)."""

    def __init__(self, params, shadow):
        self.params, self.shadow, self.saved = params, shadow, None

    def __enter__(self):
        if self.shadow is not None:
            with torch.no_grad():
                self.saved = [p.detach().clone() for p in self.params]
                for p, s in zip(self.params, self.shadow):
                    p.copy_(s)
        return self

    def __exit__(self, *exc):
        if self.saved is not None:
            with torch.no_grad():
                for p, s in zip(self.params, self.saved):
                    p.copy_(s)
            self.saved = None
        return False

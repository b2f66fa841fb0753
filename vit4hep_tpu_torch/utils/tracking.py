"""Experiment tracking (counterpart of ``vit4hep_tpu/utils/tracking.py``).

A :class:`Tracker` appends metrics and params to
``<tracking_dir>/metrics_<run_name>.jsonl`` (one JSON object per line, with
O_APPEND writes) and, when ``mlflow`` is importable, logs them there too.
Tracking never stops a run: an mlflow failure is retried with back-off and
then logged.
"""

from __future__ import annotations

import json
import os
import random
import time
from pathlib import Path

from vit4hep_tpu_torch.utils.logger import LOGGER


class Tracker:
    """One tracked run; :meth:`log` takes the reference's ``log_mlflow``
    arguments."""

    def __init__(self, tracking_dir: str, exp_name: str, run_name: str):
        Path(tracking_dir).mkdir(parents=True, exist_ok=True)
        self.path = Path(tracking_dir) / f"metrics_{run_name}.jsonl"
        self._append({"type": "run_start", "exp_name": exp_name, "run_name": run_name,
                      "time": time.time()})
        try:
            import mlflow
        except ImportError:
            mlflow = None
        self._mlflow = mlflow
        if mlflow is not None:
            try:
                mlflow.set_tracking_uri(f"sqlite:///{Path(tracking_dir) / 'mlflow.db'}")
                mlflow.set_experiment(exp_name)
                mlflow.start_run(run_name=run_name)
            except Exception as e:  # noqa: BLE001 - tracking must never stop a run
                LOGGER.warning(f"mlflow backend unavailable ({e}); using the JSONL store only")
                self._mlflow = None

    def _append(self, record: dict):
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, (json.dumps(record) + "\n").encode())
        finally:
            os.close(fd)

    def log(self, key, value=None, step=0, kind="metric"):
        self._append({"type": kind, "key": str(key), "value": _jsonable(value), "step": int(step)})
        if self._mlflow is None:
            return
        sleep = 0.1
        for _ in range(20):
            try:
                if kind == "metric":
                    self._mlflow.log_metric(key, value, step=step)
                elif kind == "param":
                    self._mlflow.log_param(key, value)
                else:
                    raise ValueError(f"kind={kind} not implemented")
                return
            except ValueError:
                raise
            except Exception:  # noqa: BLE001 - a locked db or a server hiccup
                time.sleep(sleep)
                sleep *= 1 + random.random()
        LOGGER.warning(f"Could not log {kind} {key} to mlflow after 20 attempts")

    def close(self):
        self._append({"type": "run_end", "time": time.time()})
        if self._mlflow is not None:
            try:
                self._mlflow.end_run()
            except Exception as e:  # noqa: BLE001
                LOGGER.warning(f"mlflow end_run failed: {e}")


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        try:
            return float(v)
        except (TypeError, ValueError):
            return str(v)

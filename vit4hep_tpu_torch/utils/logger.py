"""The port's logger (counterpart of ``vit4hep_tpu/utils/logger.py``).

Records emitted before a run directory exists are buffered in memory and
flushed once :func:`init_logging` attaches the handlers; each run gets its
own ``out_<run_idx>.log``. Calling :func:`init_logging` again (a second
experiment in the same process, e.g. a warm start) replaces the handlers of
the first.
"""

from __future__ import annotations

import logging
import logging.handlers
from pathlib import Path

FORMATTER = logging.Formatter(
    "[%(asctime)s %(levelname)7s %(filename)s:%(lineno)s] %(message)s",
    datefmt="%Y-%m-%d %H:%M:%S",
)

LOGGER = logging.getLogger("vit4hep-tpu-torch")
LOGGER.setLevel(logging.DEBUG)
LOGGER.propagate = False
_BUFFER = logging.handlers.MemoryHandler(capacity=1000, flushLevel=logging.CRITICAL + 1)
LOGGER.addHandler(_BUFFER)


class RankFilter(logging.Filter):
    """Drop every record on a rank other than 0 (JAX ``utils/logger.py:32-37``)."""

    def __init__(self, rank):
        super().__init__()
        self.rank = rank

    def filter(self, record):
        return self.rank == 0


def init_logging(run_dir: str | None, run_idx: int = 0, debug: bool = False, rank: int = 0):
    """Attach a stream handler and, with a run dir, the run's log file; flush
    the records buffered before. On a rank other than 0 the records after
    that flush are dropped."""
    for h in list(LOGGER.handlers):
        if h is not _BUFFER:
            LOGGER.removeHandler(h)
            h.close()
    for f in list(LOGGER.filters):
        LOGGER.removeFilter(f)
    LOGGER.setLevel(logging.DEBUG if debug else logging.INFO)
    stream = logging.StreamHandler()
    stream.setFormatter(FORMATTER)
    handlers = [stream]
    if run_dir is not None:
        file_handler = logging.FileHandler(Path(run_dir) / f"out_{run_idx}.log")
        file_handler.setFormatter(FORMATTER)
        handlers.append(file_handler)
    for h in handlers:
        LOGGER.addHandler(h)
    pending, _BUFFER.buffer = _BUFFER.buffer, []
    LOGGER.removeHandler(_BUFFER)
    for record in pending:
        if record.levelno >= LOGGER.level:
            for h in handlers:
                h.handle(record)
    LOGGER.addFilter(RankFilter(rank))
    LOGGER.debug("Logger initialized")


def flush_buffered_logs():
    """Dump records still buffered (a crash before :func:`init_logging`) to
    stderr."""
    if _BUFFER in LOGGER.handlers and _BUFFER.buffer:
        stream = logging.StreamHandler()
        stream.setFormatter(FORMATTER)
        for record in _BUFFER.buffer:
            stream.handle(record)
        _BUFFER.buffer = []

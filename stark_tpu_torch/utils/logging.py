# Copied from stark_tpu/utils/logging.py (host-only); its profile_trace,
# a jax.profiler scope there, is a torch.profiler scope here.
"""Logging for the CLI and the prover daemon.

The event format ``[timestamp] [LEVEL] [thread ThreadId(n)] file:line -
message``, two sinks (the console with ANSI colours when it is a
terminal, and a plain daily file ``logs/output.log.<date>`` under the
checkout), and the level from ``STARK_LOG`` (default "info").  Handlers
flush on close.  :func:`profile_trace` writes a Chrome trace of a scope.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import sys
import threading

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

logging.addLevelName(5, "TRACE")

# the logger's name, and the default file sink beside the package
LOGGER = "stark_tpu_torch"
LOG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "logs")


class _RefFormatter(logging.Formatter):
    """[timestamp] [LEVEL] [thread ThreadId(n)] file:line - message"""

    def __init__(self, ansi: bool):
        super().__init__()
        self.ansi = ansi

    _COLORS = {
        "TRACE": "\x1b[35m", "DEBUG": "\x1b[34m", "INFO": "\x1b[32m",
        "WARNING": "\x1b[33m", "ERROR": "\x1b[31m",
    }

    def format(self, record: logging.LogRecord) -> str:
        ts = datetime.datetime.fromtimestamp(record.created).strftime(
            "%Y-%m-%d %H:%M:%S.%f"
        )[:-3]
        level = record.levelname
        if self.ansi and level in self._COLORS:
            level_s = f"{self._COLORS[level]}{level}\x1b[0m"
        else:
            level_s = level
        tid = threading.get_ident() % 100000
        return (
            f"[{ts}] [{level_s}] [thread ThreadId({tid})] "
            f"{record.filename}:{record.lineno} - {record.getMessage()}"
        )


_configured = False


def setup_logging(log_dir: str = LOG_DIR,
                  level: str | None = None) -> logging.Logger:
    """Configure the ``stark_tpu_torch`` logger: console + daily file
    sink."""
    global _configured
    logger = logging.getLogger(LOGGER)
    if _configured:
        return logger
    _configured = True
    lvl = _LEVELS.get((level or os.environ.get("STARK_LOG", "info")).lower(),
                      logging.INFO)
    logger.setLevel(lvl)

    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(_RefFormatter(ansi=sys.stderr.isatty()))
    logger.addHandler(console)

    try:
        os.makedirs(log_dir, exist_ok=True)
        day = datetime.date.today().isoformat()
        fh = logging.FileHandler(os.path.join(log_dir, f"output.log.{day}"))
        fh.setFormatter(_RefFormatter(ansi=False))
        logger.addHandler(fh)
    except OSError:
        pass
    return logger


def get_logger() -> logging.Logger:
    return logging.getLogger(LOGGER)


@contextlib.contextmanager
def profile_trace(log_dir: str = os.path.join(LOG_DIR, "torch-trace")):
    """A ``torch.profiler`` scope over the CPU and, when there is one, the
    CUDA device, exported as a Chrome trace (chrome://tracing, Perfetto)
    into `log_dir` on exit.  Yields the trace file's path.

    A prove inside the scope shows its spans (``utils/metrics.py``) as
    ``span:<name>`` ranges beside the kernels they launch: the five
    phases, ``host-trace``, ``intt``, ``coset-ntt``, each fold's
    ``fri-draw``, ``fold`` and ``layer-tree``, and ``host-replay``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S-%f")
    path = os.path.join(log_dir, f"trace-{stamp}-{os.getpid()}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)

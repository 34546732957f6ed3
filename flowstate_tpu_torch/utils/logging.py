"""Experiment logging: per-run file + stream handlers and structured metrics.

Port of ``flowstate_tpu/utils/logging.py`` (``setup_logger``,
``MetricsWriter``, ``save_params_json``), unchanged apart from turning
torch tensors into JSON values.

TPU-native equivalent of the reference ``setup_logger``
(``hybrid_NF_MCMC/utils.py:32-47``) plus a structured JSONL metrics writer
(the reference persists metrics as ad-hoc CSV/JSON per plot; here every
metric event also lands in one machine-readable stream, SURVEY.md §5).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict


def setup_logger(logger_name: str, log_file: str,
                 file_level: int = logging.DEBUG,
                 stream_level: int = logging.WARNING) -> logging.Logger:
    """File + stream logger; reference utils.py:32-47 semantics."""
    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.hasHandlers():
        logger.handlers.clear()
    os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
    fh = logging.FileHandler(log_file)
    fh.setLevel(file_level)
    ch = logging.StreamHandler()
    ch.setLevel(stream_level)
    formatter = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    fh.setFormatter(formatter)
    ch.setFormatter(formatter)
    logger.addHandler(fh)
    logger.addHandler(ch)
    return logger


def save_params_json(params: Dict[str, Any], directory: str,
                     filename: str = "params.json") -> str:
    """Write ``params`` as indented JSON into ``directory`` (made if
    missing), numpy values and tensors as numbers and lists; returns the
    path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, filename)
    with open(path, "w") as f:
        json.dump(params, f, indent=4, default=_json_default)
    return path


class MetricsWriter:
    """Append-only JSONL metrics stream (one event per line)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a")

    def log(self, event: str, **fields: Any) -> None:
        record: Dict[str, Any] = {"t": time.time(), "event": event}
        record.update(fields)
        self._fh.write(json.dumps(record, default=_json_default) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def _json_default(o):
    import numpy as np
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if hasattr(o, "detach"):  # torch tensors, on any device
        o = o.detach().cpu().numpy()
    if hasattr(o, "__array__"):  # numpy arrays (incl. 0-d scalars)
        a = np.asarray(o)
        return a.item() if a.ndim == 0 else a.tolist()
    return str(o)


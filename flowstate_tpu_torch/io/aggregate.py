"""Shared-results aggregation: flock-protected CSV fan-in.

Port of ``flowstate_tpu/io/aggregate.py``, the equivalent of the
reference's ``MCMC/scripts/append_results.py``: reads a run's
``sampled_data.csv``, averages post-equilibration pressure / density /
aspect ratio (``append_results.py:6-70``), and appends one row to a shared
``results.csv`` under an exclusive lock (``:73-77``).

The append is one ``write`` of the row (and, into an empty file, the
header) to a file opened ``O_APPEND``, under ``flock(LOCK_EX)``, then
``fsync``, so many sweep processes can fan into one ``results.csv`` without
a torn line, and a row is on disk when the call returns.  This is host
file I/O; no device is involved.
"""

from __future__ import annotations

import csv
import fcntl
import os

import numpy as np

RESULTS_HEADER = "temperature,density,pressure,aspect_ratio"


def append_row_locked(path: str, row: str,
                      header: str = RESULTS_HEADER) -> None:
    """Append one CSV row under an exclusive lock (header on first write)."""
    fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)     # released when fd is closed
        data = row + "\n"
        if header and os.fstat(fd).st_size == 0:
            data = header + "\n" + data
        data = data.encode()
        while data:
            data = data[os.write(fd, data):]
        os.fsync(fd)
    finally:
        os.close(fd)


def append_results(results_csv: str, output_path: str, temperature: float,
                   equilibration_steps: int) -> dict:
    """Summarize one run and append to the shared results CSV.

    Reference ``append_results.py:6-106``: average post-equilibration
    pressure, density, and aspect ratio from ``sampled_data.csv``.
    """
    sampled = os.path.join(output_path, "sampled_data.csv")
    with open(sampled) as f:
        reader = csv.reader(f)
        next(reader)  # header
        rows = list(reader)
    # Reference CSVs count cycles across equilibration+production; if no
    # row exceeds the threshold, every row is already post-equilibration
    # and all are kept.
    if rows and max(int(r[0]) for r in rows) > equilibration_steps:
        rows = [r for r in rows if int(r[0]) > equilibration_steps]
    pressures, densities, aspect_ratios = [], [], []
    for rowvals in rows:
        densities.append(float(rowvals[2]))
        pressures.append(float(rowvals[3]))
        aspect_ratios.append(float(rowvals[4]) / float(rowvals[5]))
    summary = {
        "temperature": temperature,
        "density": float(np.mean(densities)) if densities else float("nan"),
        "pressure": float(np.mean(pressures)) if pressures else float("nan"),
        "aspect_ratio": (float(np.mean(aspect_ratios))
                         if aspect_ratios else float("nan")),
    }
    row = (f"{summary['temperature']},{summary['density']},"
           f"{summary['pressure']},{summary['aspect_ratio']}")
    append_row_locked(results_csv, row)
    return summary

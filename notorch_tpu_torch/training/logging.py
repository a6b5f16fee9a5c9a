"""Metric logging sinks.

Port of ``notorch_tpu.training.logging``: composable host-side sinks that
the training loop's ``log_fn`` feeds. ``JSONLLogger`` appends one JSON
object a record (with ``wall_time``, the seconds since the logger was
made), ``CSVLogger`` rewrites a wide CSV with a stable, growing header,
``StdoutLogger`` prints ``key=value`` pairs and ``MultiLogger`` fans a
record out. Values are written as the JAX sinks write them: numbers
rounded to 6 decimals (a device scalar is read to the host here), anything
else as its string.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def _scalar(v):
    try:
        return round(float(v), 6)
    except (TypeError, ValueError):
        return str(v)


class JSONLLogger:
    """One JSON object per record, appended to a file."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._t0 = time.time()

    def __call__(self, record: dict) -> None:
        out = {"wall_time": round(time.time() - self._t0, 3)}
        out.update({k: _scalar(v) for k, v in record.items()})
        with self.path.open("a") as f:
            f.write(json.dumps(out) + "\n")


class CSVLogger:
    """Wide CSV with a stable, growing header."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._columns: list[str] = []
        self._rows: list[dict] = []

    def __call__(self, record: dict) -> None:
        row = {k: _scalar(v) for k, v in record.items()}
        self._rows.append(row)
        for k in row:
            if k not in self._columns:
                self._columns.append(k)
        with self.path.open("w") as f:
            f.write(",".join(self._columns) + "\n")
            for r in self._rows:
                f.write(",".join(str(r.get(c, "")) for c in self._columns) + "\n")


class StdoutLogger:
    def __init__(self, stream=None):
        self.stream = stream or sys.stdout

    def __call__(self, record: dict) -> None:
        print("  ".join(f"{k}={_scalar(v)}" for k, v in record.items()), file=self.stream)


class MultiLogger:
    def __init__(self, *loggers):
        self.loggers = loggers

    def __call__(self, record: dict) -> None:
        for lg in self.loggers:
            lg(record)

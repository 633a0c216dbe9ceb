"""Structured JSONL metrics logging.

A copy of ``itsd_tpu/utils/logging.py:MetricsLogger``: an append-only JSONL
stream that tools can tail, one JSON object a line. ``log`` can leave a
record out of the printed echo (the train loop's per-step records).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, also_print: bool = True):
        self.path = path
        self.also_print = also_print
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")
        else:
            self._fh = None

    def log(self, record: Dict[str, Any],
            echo: Optional[bool] = None) -> None:
        """Append ``record`` (with its time); print it too when ``echo``,
        which defaults to ``also_print``."""
        record = dict(record)
        record.setdefault("time", time.time())
        line = json.dumps(record, default=float)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.also_print if echo is None else echo:
            short = {k: (round(v, 6) if isinstance(v, float) else v)
                     for k, v in record.items() if k != "time"}
            print(short)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

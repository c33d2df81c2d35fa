"""Structured metrics (counterpart of ``JsonlMetrics`` in
``py_psnode_tpu/utils/profiling.py:59``): one JSON object per line,
appended and flushed as it is logged."""

from __future__ import annotations

import json
import pathlib
import time


class JsonlMetrics:
    def __init__(self, path):
        self.path = pathlib.Path(path)
        self._f = open(self.path, "a")

    def log(self, **kv):
        kv.setdefault("ts", time.time())
        self._f.write(json.dumps(kv) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

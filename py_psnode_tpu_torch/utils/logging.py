"""Dual-file training/testing logger (counterpart of
``py_psnode_tpu/utils/logging.py``).

Up to two log files (``training.log`` / ``testing.log``); every line is
mirrored to the console. Uses ``tqdm.write`` when tqdm is installed so
progress bars stay intact; plain print otherwise.
"""

from __future__ import annotations

import pathlib
from typing import Optional

try:
    from tqdm import tqdm

    _write = tqdm.write
except ImportError:  # pragma: no cover
    _write = print


class Logger:
    def __init__(
        self,
        logfile_path: pathlib.Path,
        train_log_name: Optional[str] = None,
        test_log_name: Optional[str] = None,
        echo: bool = True,
    ):
        logfile_path = pathlib.Path(logfile_path)
        self.training_logfile = (
            None if train_log_name is None else open(logfile_path / train_log_name, "w")
        )
        self.testing_logfile = (
            None if test_log_name is None else open(logfile_path / test_log_name, "w")
        )
        self.echo = echo

    def close(self):
        if self.training_logfile is not None:
            self.training_logfile.close()
            self.training_logfile = None
        if self.testing_logfile is not None:
            self.testing_logfile.close()
            self.testing_logfile = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _log(self, f, strs):
        string = " ".join(str(s) for s in strs)
        if f is not None:
            f.write(string + "\n")
            f.flush()
        if self.echo:
            _write(string)

    def training_log(self, *strs):
        self._log(self.training_logfile, strs)

    def testing_log(self, *strs):
        self._log(self.testing_logfile, strs)

"""Timestamped, indentation-aware run logger.

Parity: bayesNMF_sampler$log (bayesNMF_sampler.R:423-455): verbosity-gated,
tab-indented, per-write flushed ``log.txt`` in the output directory, with
continuation lines aligned under the timestamp.
"""

from __future__ import annotations

import datetime
import io
import os
from typing import Optional


class RunLogger:
    def __init__(self, output_dir: Optional[str], verbosity: int = 1,
                 mode: str = "w", mesh=None):
        """``mode='a'`` appends, so a run resumed from a checkpoint keeps
        writing to the original log.txt. On a mesh (parallel/mesh.py) only
        the root rank writes; the other ranks are silent."""
        self.verbosity = verbosity
        self.indent = 0
        self._fh: Optional[io.TextIOBase] = None
        if mesh is not None and not mesh.is_root:
            output_dir = None
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
            self._fh = open(os.path.join(output_dir, "log.txt"), mode)

    def log(self, msg: str, verbosity: int = 5):
        if verbosity > self.verbosity or not msg:
            return
        ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        indent = "\t" * self.indent
        lines = [ln for ln in str(msg).split("\n") if ln.strip() != ""]
        out = []
        for i, ln in enumerate(lines):
            pad = indent if i == 0 else indent + " " * (len(ts) + 1)
            out.append(pad + ln)
        if self._fh is not None:
            self._fh.write(f"[{ts}] " + "\n".join(out) + "\n")
            self._fh.flush()

    def error(self, msg: str):
        self.log("ERROR: " + msg, verbosity=0)
        raise RuntimeError(msg)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __del__(self):  # the reference's finalize closes the log connection
        try:
            self.close()
        except Exception:
            pass


def format_counts_table(counts) -> str:
    """Render A-mode counts as an aligned table for the log (log_table,
    helpers.R:87-100)."""
    pats = [p for p, _ in counts]
    vals = [str(c) for _, c in counts]
    widths = [max(len(p), len(v)) for p, v in zip(pats, vals)]
    head = "  ".join(p.center(w) for p, w in zip(pats, widths))
    body = "  ".join(v.center(w) for v, w in zip(vals, widths))
    return head + "\n" + body

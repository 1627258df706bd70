"""Minimal reader for R's RDS serialization (version 2/3, XDR).

The port's own copy of bayesnmf_tpu/utils/rds.py (numpy only), so the port
loads the reference package's example dataset (inst/extdata/
example_data.rds: list(M=96x64 counts, P=96x4 true signatures), carried
under bayesnmf_tpu_torch/data/) without an R runtime and without the JAX
package. Supports the subset of SEXP types an RDS of nested lists /
numeric matrices / strings needs: VECSXP, REALSXP, INTSXP, LGLSXP,
STRSXP/CHARSXP, S4-free attributes (names/dim/dimnames), symbols and the
reference table.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Any

import numpy as np

# SEXP type codes (R internals)
_NILSXP = 0
_SYMSXP = 1
_LISTSXP = 2
_CHARSXP = 9
_LGLSXP = 10
_INTSXP = 13
_REALSXP = 14
_STRSXP = 16
_VECSXP = 19
_NILVALUE = 254
_REFSXP = 255
_NA_INT = -2147483648


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.refs: list[Any] = []

    def _int(self) -> int:
        (v,) = struct.unpack_from(">i", self.buf, self.pos)
        self.pos += 4
        return v

    def _double(self, n) -> np.ndarray:
        out = np.frombuffer(self.buf, ">f8", count=n, offset=self.pos).astype(np.float64)
        self.pos += 8 * n
        return out

    def _ints(self, n) -> np.ndarray:
        out = np.frombuffer(self.buf, ">i4", count=n, offset=self.pos).astype(np.int64)
        self.pos += 4 * n
        return out

    def read(self):
        magic = self.buf[self.pos:self.pos + 2]
        if magic != b"X\n":
            raise ValueError("only XDR-format RDS is supported")
        self.pos += 2
        version = self._int()
        self._int()  # writer version
        self._int()  # min reader version
        if version >= 3:
            enc_len = self._int()
            self.pos += enc_len  # native encoding string
        return self.item()

    def item(self):
        flags = self._int()
        typ = flags & 0xFF
        has_attr = bool(flags & 0x200)
        has_tag = bool(flags & 0x400)

        if typ == _NILVALUE or typ == _NILSXP:
            return None
        if typ == _REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self._int()
            return self.refs[idx - 1]
        if typ == _SYMSXP:
            name = self.item()  # CHARSXP
            self.refs.append(name)
            return name
        if typ == _CHARSXP:
            n = self._int()
            if n == -1:
                return None
            s = self.buf[self.pos:self.pos + n].decode("utf-8", "replace")
            self.pos += n
            return s
        if typ == _LISTSXP:  # pairlist node (attribute chains)
            attr = self.item() if has_attr else None  # noqa: F841
            tag = self.item() if has_tag else None
            car = self.item()
            cdr = self.item()
            pairs = [(tag, car)]
            if isinstance(cdr, list):
                pairs.extend(cdr)
            return pairs
        if typ in (_LGLSXP, _INTSXP):
            n = self._int()
            vals = self._ints(n)
            if typ == _LGLSXP:
                out = vals.astype(object)
                out[vals == _NA_INT] = None
                vals = out if (vals == _NA_INT).any() else vals.astype(bool)
            return self._with_attrs(vals, has_attr)
        if typ == _REALSXP:
            n = self._int()
            return self._with_attrs(self._double(n), has_attr)
        if typ == _STRSXP:
            n = self._int()
            vals = np.array([self.item() for _ in range(n)], object)
            return self._with_attrs(vals, has_attr)
        if typ == _VECSXP:
            n = self._int()
            vals = [self.item() for _ in range(n)]
            return self._with_attrs(vals, has_attr)
        raise ValueError(f"unsupported SEXP type {typ} at offset {self.pos}")

    def _with_attrs(self, value, has_attr: bool):
        if not has_attr:
            return value
        attrs = dict(self.item() or [])
        dim = attrs.get("dim")
        if dim is not None and isinstance(value, np.ndarray):
            value = value.reshape(tuple(int(d) for d in dim), order="F")
        names = attrs.get("names")
        if names is not None and isinstance(value, list):
            value = {str(k): v for k, v in zip(names, value)}
        dimnames = attrs.get("dimnames")
        if dimnames is not None and isinstance(value, np.ndarray) and value.ndim == 2:
            import pandas as pd

            rn = dimnames[0] if isinstance(dimnames, list) else None
            cn = dimnames[1] if isinstance(dimnames, list) and len(dimnames) > 1 else None
            value = pd.DataFrame(value, index=rn, columns=cn)
        return value


def read_rds(path: str):
    """Read an RDS file into numpy/pandas/dict structures."""
    with open(path, "rb") as fh:
        head = fh.read(2)
        fh.seek(0)
        raw = fh.read()
    if head == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return _Reader(raw).read()


EXAMPLE_RDS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "example_data.rds")


def load_example_data():
    """The reference package's simulated example dataset: dict with 'M'
    (96x64 counts) and 'P' (96x4 true signatures)."""
    return read_rds(EXAMPLE_RDS)

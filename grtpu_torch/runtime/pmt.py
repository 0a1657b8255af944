"""PMT — polymorphic message type for the control plane.

grtpu_torch's own copy of ``grtpu.runtime.pmt`` (numpy only; a test holds
the two byte for byte, both ways).  Analog of gruel/pmt (gruel/src/include/gruel/pmt.h:59-177,
gruel/src/lib/pmt/pmt.cc): a scheme-like dynamic value used for async
messages and tag values.  In a Python-control-plane framework the natural
carrier is the Python object itself, so PMTs here are ordinary Python values
with a thin functional veneer that preserves the reference's API shape
(construction, predicates, accessors) plus binary serialization for
inter-process transport (analog of pmt_serialize).

Supported kinds: None (PMT_NIL), bool, symbol (str), int, float, complex,
pair/tuple/list, uniform numeric vectors (numpy arrays), dict.
"""

from __future__ import annotations

import io
import pickle
import struct
from typing import Any

import numpy as np

PMT_NIL = None
PMT_T = True
PMT_F = False


# -- constructors (pmt.h naming: pmt_from_*, pmt_make_*) ----------------------
def from_bool(v: bool):
    return bool(v)


def from_long(v: int):
    return int(v)


def from_uint64(v: int):
    return int(v)


def from_double(v: float):
    return float(v)


def from_complex(v: complex):
    return complex(v)


def string_to_symbol(s: str):
    return str(s)


intern = string_to_symbol


def cons(car, cdr):
    return (car, cdr)


def make_tuple(*items):
    return tuple(items)


def make_dict():
    return {}


def dict_add(d: dict, k, v):
    d2 = dict(d)
    d2[k] = v
    return d2


def dict_ref(d: dict, k, default=PMT_NIL):
    return d.get(k, default)


def make_u8vector(n, fill=0):
    return np.full(n, fill, dtype=np.uint8)


def make_f32vector(n, fill=0.0):
    return np.full(n, fill, dtype=np.float32)


def make_c32vector(n, fill=0j):
    return np.full(n, fill, dtype=np.complex64)


def init_u8vector(n, data):
    return np.asarray(data, dtype=np.uint8)[:n]


def to_python(p):
    return p


def to_pmt(v):
    return v


# -- predicates ---------------------------------------------------------------
def is_null(p):
    return p is None


def is_bool(p):
    return isinstance(p, bool)


def is_symbol(p):
    return isinstance(p, str)


def is_integer(p):
    return isinstance(p, int) and not isinstance(p, bool)


def is_real(p):
    return isinstance(p, float)


def is_complex(p):
    return isinstance(p, complex)


def is_pair(p):
    return isinstance(p, tuple) and len(p) == 2


def is_dict(p):
    return isinstance(p, dict)


def is_uniform_vector(p):
    return isinstance(p, np.ndarray)


# -- accessors ----------------------------------------------------------------
def car(p):
    return p[0]


def cdr(p):
    return p[1]


def to_long(p):
    return int(p)


def to_double(p):
    return float(p)


def symbol_to_string(p):
    return str(p)


def length(p):
    return len(p)


# -- serialization (analog of pmt_serialize / pmt_deserialize) ----------------
_MAGIC = b"GPMT"


def serialize(p) -> bytes:
    """Binary-serialize a PMT.  Numeric vectors use a compact raw encoding;
    everything else falls back to pickle (control-plane only, trusted peers).
    """
    buf = io.BytesIO()
    buf.write(_MAGIC)
    if isinstance(p, np.ndarray):
        buf.write(b"V")
        dt = p.dtype.str.encode()
        buf.write(struct.pack("<B", len(dt)))
        buf.write(dt)
        buf.write(struct.pack("<I", p.ndim))
        for s in p.shape:
            buf.write(struct.pack("<Q", s))
        buf.write(np.ascontiguousarray(p).tobytes())
    else:
        buf.write(b"P")
        buf.write(pickle.dumps(p, protocol=4))
    return buf.getvalue()


def deserialize(data: bytes):
    if data[:4] != _MAGIC:
        raise ValueError("not a serialized PMT")
    kind = data[4:5]
    body = data[5:]
    if kind == b"V":
        (dlen,) = struct.unpack_from("<B", body, 0)
        dt = np.dtype(body[1:1 + dlen].decode())
        off = 1 + dlen
        (ndim,) = struct.unpack_from("<I", body, off)
        off += 4
        shape = []
        for _ in range(ndim):
            (s,) = struct.unpack_from("<Q", body, off)
            shape.append(s)
            off += 8
        return np.frombuffer(body[off:], dtype=dt).reshape(shape).copy()
    return pickle.loads(body)

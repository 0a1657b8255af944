"""Engineering notation helpers (gnuradio-core/src/python/gnuradio/
eng_notation.py analog: num_to_str / str_to_num with SI suffixes)."""

from __future__ import annotations

scale_factor = {
    "E": 1e18, "P": 1e15, "T": 1e12, "G": 1e9, "M": 1e6, "k": 1e3,
    "m": 1e-3, "u": 1e-6, "n": 1e-9, "p": 1e-12, "f": 1e-15, "a": 1e-18,
}


def num_to_str(n: float) -> str:
    """3-significant-digit engineering string: 2.5M, 1.25k, 10.0 ..."""
    m = abs(n)
    for suf, mult in (("E", 1e18), ("P", 1e15), ("T", 1e12), ("G", 1e9),
                      ("M", 1e6), ("k", 1e3)):
        if m >= mult:
            return f"{n / mult:g}{suf}"
    if m >= 1 or m == 0:
        return f"{n:g}"
    for suf, mult in (("m", 1e-3), ("u", 1e-6), ("n", 1e-9), ("p", 1e-12),
                      ("f", 1e-15)):
        if m >= mult:
            return f"{n / mult:g}{suf}"
    return f"{n:g}"


def str_to_num(s: str) -> float:
    """Parse '2.5M', '100k', '10u' ... (eng_notation.str_to_num)."""
    s = s.strip()
    if s and s[-1] in scale_factor:
        return float(s[:-1]) * scale_factor[s[-1]]
    return float(s)

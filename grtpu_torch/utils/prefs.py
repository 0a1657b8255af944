"""Configuration / preferences system.

Port of ``grtpu.utils.prefs`` (the same files and ``GRTPU_*`` variables, so
both packages read one configuration).

Analogs (SURVEY.md §5.6): gr_prefs (INI files from /etc/gnuradio/conf.d +
~/.gnuradio/config.conf, general/gr_prefs.h:36-78 + python prefs.py
singleton) and gr_preferences (file-per-key store used for the vmcircbuf
factory choice and volk's config).

grtpu reads ``~/.grtpu/config.conf`` (INI) plus ``GRTPU_*`` environment
overrides (section_option -> GRTPU_SECTION_OPTION).  Consumers: default
chunk size, FIR impl heuristics, bench shapes.
"""

from __future__ import annotations

import configparser
import os
from typing import Optional

_singleton = None


class Prefs:
    def __init__(self, paths=None):
        self._cp = configparser.ConfigParser()
        if paths is None:
            paths = [
                "/etc/grtpu/conf.d/config.conf",
                os.path.expanduser("~/.grtpu/config.conf"),
            ]
        self._cp.read(paths)

    # -- gr_prefs API shape -------------------------------------------------
    def has_section(self, section: str) -> bool:
        return self._cp.has_section(section)

    def has_option(self, section: str, option: str) -> bool:
        return self._env(section, option) is not None or \
            self._cp.has_option(section, option)

    def _env(self, section, option) -> Optional[str]:
        return os.environ.get(f"GRTPU_{section.upper()}_{option.upper()}")

    def get_string(self, section, option, default="") -> str:
        v = self._env(section, option)
        if v is not None:
            return v
        return self._cp.get(section, option, fallback=default)

    def get_long(self, section, option, default=0) -> int:
        try:
            return int(self.get_string(section, option, str(default)))
        except ValueError:
            return default

    def get_double(self, section, option, default=0.0) -> float:
        try:
            return float(self.get_string(section, option, str(default)))
        except ValueError:
            return default

    def get_bool(self, section, option, default=False) -> bool:
        v = self.get_string(section, option, str(default)).lower()
        return v in ("1", "true", "yes", "on")


def prefs() -> Prefs:
    """Singleton accessor (gr_prefs::singleton)."""
    global _singleton
    if _singleton is None:
        _singleton = Prefs()
    return _singleton


# -------------------- gr_preferences-style file-per-key store ---------------
def _store_dir() -> str:
    d = os.path.expanduser("~/.grtpu/prefs")
    os.makedirs(d, exist_ok=True)
    return d


def get_pref(key: str, default: str = "") -> str:
    """gr_preferences::get (file per key under ~/.grtpu/prefs)."""
    path = os.path.join(_store_dir(), key)
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return default


def set_pref(key: str, value: str):
    """gr_preferences::set."""
    with open(os.path.join(_store_dir(), key), "w") as f:
        f.write(str(value))

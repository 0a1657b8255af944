"""Modem registry (gr-digital/python/modulation_utils.py analog), in
PyTorch.

Port of ``grtpu.digital.modulation_utils``: registries of modulator /
demodulator classes (add_type_1_mod / type_1_mods /
extract_kwargs_from_options) so apps can select a modulation by name, over
the port's burst modem classes.
"""

from __future__ import annotations

import inspect
from typing import Dict

_mods: Dict[str, type] = {}
_demods: Dict[str, type] = {}


def add_type_1_mod(name: str, cls: type):
    _mods[name] = cls


def add_type_1_demod(name: str, cls: type):
    _demods[name] = cls


def type_1_mods() -> Dict[str, type]:
    return dict(_mods)


def type_1_demods() -> Dict[str, type]:
    return dict(_demods)


def extract_kwargs_from_options(cls: type, options) -> dict:
    """Pull constructor kwargs out of an argparse/optparse options object
    (modulation_utils.extract_kwargs_from_options)."""
    sig = inspect.signature(cls.__init__)
    kwargs = {}
    for pname in sig.parameters:
        if pname == "self":
            continue
        if hasattr(options, pname) and getattr(options, pname) is not None:
            kwargs[pname] = getattr(options, pname)
    return kwargs


def _populate():
    from grtpu_torch.digital.modems import Fsk4Modem, GmskModem, PskModem

    for name, cls in (("gmsk", GmskModem), ("dbpsk", PskModem),
                      ("4fsk", Fsk4Modem)):
        add_type_1_mod(name, cls)
        add_type_1_demod(name, cls)


_populate()

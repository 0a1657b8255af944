"""The input generators repeat from their seed, and seeds differ."""

import json

import torch

from radiobench import signals
from radiobench.tests.conftest import ROOT

WBFM = json.loads((ROOT / "radiobench/configs/wbfm_rcv256.json").read_text())
DMR = json.loads((ROOT / "radiobench/configs/dmr_4fsk48k.json").read_text())


def test_capture_repeats_from_its_seed():
    a = signals.wideband_capture(WBFM, 4096, 2, 2 ** 33 + 1, "cpu")
    b = signals.wideband_capture(WBFM, 4096, 2, 2 ** 33 + 1, "cpu")
    c = signals.wideband_capture(WBFM, 4096, 2, 2 ** 33 + 2, "cpu")
    assert a.dtype == torch.complex64 and a.shape == (2, 4096)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])


def test_dmr_bursts_repeat_from_their_seed():
    def make(seed):
        d = signals.dmr_dibits(3, 1728, seed, 7, "cpu")
        return d, signals.dmr_channel(signals.fsk4_modulate(d, DMR), DMR, seed, 8)

    (d1, x1), (d2, x2), (d3, x3) = make(5), make(5), make(6)
    assert torch.equal(d1, d2) and torch.equal(x1, x2)
    assert not torch.equal(x1, x3)
    assert x1.shape == (3, 17280) and x1.dtype == torch.complex64


def test_every_slot_carries_the_bs_data_sync():
    d = signals.dmr_dibits(2, 12 * signals.SLOT_DIBITS, 9, 3, "cpu")
    slots = d.reshape(2, 12, signals.SLOT_DIBITS)
    at = signals.CACH_DIBITS + signals.PAYLOAD_HALF_DIBITS
    sync = slots[:, :, at:at + 24].reshape(-1, 24)
    bits = 0
    for v in sync[0].tolist():
        bits = bits << 2 | v
    assert bits == signals.BS_DATA_SYNC
    assert (sync == sync[0]).all()

"""Parity of grtpu_torch.fec with grtpu.fec on the CPU.

``fec.rs`` is a numpy copy: tables, generator polynomials, parity, syndromes
and corrections identical to grtpu's for the CCSDS, plain and ATSC codes.
``fec.conv`` is torch: the CCSDS k=7 encoder's bits and the 64-state
Viterbi's decisions identical to grtpu's (every step one float32 add or
compare in grtpu's order), and the two stream blocks through the port's
executor against grtpu's blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtpu.fec import conv as jconv, rs as jrs
from grtpu_torch import Graph, Port, StreamExecutor
from grtpu_torch.fec import conv as tconv, rs as trs
from grtpu_torch.utils.testing import run_block

CODES = {"ccsds": ((), {}), "simple": ((16, 0), {}), "atsc": ((), {})}
MAKERS = {"ccsds": "rs_ccsds", "simple": "rs_simple", "atsc": "rs_atsc"}


def pair(name):
    args, kw = CODES[name]
    return (getattr(jrs, MAKERS[name])(*args, **kw),
            getattr(trs, MAKERS[name])(*args, **kw))


@pytest.mark.parametrize("name", list(CODES))
def test_rs_tables_and_parity_identical(name):
    rj, rt = pair(name)
    for attr in ("alpha_to", "index_of", "genpoly"):
        np.testing.assert_array_equal(getattr(rj, attr), getattr(rt, attr))
    assert (rj.k, rj.iprim) == (rt.k, rt.iprim)
    data = np.random.RandomState(1).randint(0, 256, rj.k).astype(np.uint8)
    np.testing.assert_array_equal(rj.encode_codeword(data),
                                  rt.encode_codeword(data))


@pytest.mark.parametrize("name", list(CODES))
@pytest.mark.parametrize("nerr", [0, 3, "max", "too_many"])
def test_rs_decode_identical(name, nerr):
    rj, rt = pair(name)
    r = np.random.RandomState(2)
    cw = rt.encode_codeword(r.randint(0, 256, rt.k).astype(np.uint8))
    n = {"max": rt.nroots // 2, "too_many": rt.nroots // 2 + 3}.get(nerr, nerr)
    bad = cw.copy()
    pos = r.choice(len(cw), n, replace=False)
    bad[pos] ^= r.randint(1, 256, n).astype(np.uint8)
    np.testing.assert_array_equal(rj.syndromes(bad), rt.syndromes(bad))
    fj, ej = rj.decode(bad)
    ft, et = rt.decode(bad)
    assert ej == et
    np.testing.assert_array_equal(fj, ft)
    if nerr != "too_many":
        assert et == n
        np.testing.assert_array_equal(ft, cw)


def test_rs_decode_batch_identical():
    rj, rt = pair("atsc")
    r = np.random.RandomState(3)
    cws = np.stack([rt.encode_codeword(r.randint(0, 256, rt.k).astype(np.uint8))
                    for _ in range(12)])
    for i, n in enumerate([0, 1, 5, 10, 13, 0, 2, 0, 11, 7, 0, 4]):
        pos = r.choice(cws.shape[1], n, replace=False)
        cws[i, pos] ^= r.randint(1, 256, n).astype(np.uint8)
    for a, b in zip(rj.decode_batch(cws), rt.decode_batch(cws)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rj.syndromes_batch(cws),
                                  rt.syndromes_batch(cws))


@pytest.mark.parametrize("state", [0, 0b101101])
def test_conv_encode_identical(state):
    bits = np.random.RandomState(4).randint(0, 2, 500).astype(np.uint8)
    want = np.asarray(jconv.conv_encode_27(jnp.asarray(bits), state))
    got = tconv.conv_encode_27(torch.from_numpy(bits), state)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tconv.conv_encode_27_packed(b"grtpu", device="cpu").numpy(),
        np.asarray(jconv.conv_encode_27_packed(b"grtpu")))


@pytest.mark.parametrize("noise", [0.0, 0.6, 1.0])
def test_viterbi_decode_27_identical(noise):
    r = np.random.RandomState(5)
    bits = r.randint(0, 2, 400).astype(np.uint8)
    bits[-6:] = 0
    enc = np.asarray(jconv.conv_encode_27(jnp.asarray(bits)))
    soft = (enc.astype(np.float32) * 2 - 1
            + noise * r.randn(len(enc)).astype(np.float32))
    want = np.asarray(jconv.viterbi_decode_27(jnp.asarray(soft)))
    got = tconv.viterbi_decode_27(torch.from_numpy(soft)).numpy()
    np.testing.assert_array_equal(got, want)
    if noise <= 0.6:
        np.testing.assert_array_equal(got, bits)


def test_ccsds_blocks_identical_through_the_executor():
    data = np.random.RandomState(6).randint(0, 256, 64).astype(np.uint8)
    enc_j = jconv.EncodeCcsds27()
    _, want_enc = enc_j.apply(enc_j.init_state(), jnp.asarray(data))
    got_enc = run_block(tconv.EncodeCcsds27(), data, chunk_size=16,
                        device="cpu")
    np.testing.assert_array_equal(got_enc, np.asarray(want_enc))
    soft = (got_enc.astype(np.float32) * 2 - 1)
    dec_j = jconv.DecodeCcsds27()
    _, want_dec = dec_j.apply((), jnp.asarray(soft))
    got_dec = run_block(tconv.DecodeCcsds27(), soft, device="cpu")
    np.testing.assert_array_equal(got_dec, np.asarray(want_dec))
    g = Graph()
    g.connect(g.add_input(Port(torch.float32)), tconv.DecodeCcsds27(),
              g.add_output(Port(torch.uint8)))
    looped = StreamExecutor(g, chunk_size=len(soft), device="cpu").run(
        torch.from_numpy(soft), device_loop=True)
    np.testing.assert_array_equal(looped.numpy(), got_dec)
    # one chunk = one trellis from a flushed start: the first bytes decode
    np.testing.assert_array_equal(got_dec[:60], data[:60])

"""BASELINE config #3 on the card: the generic modem's exact chain against
the CPU, the vmapped chunked bank, and a channel model's noise resumed from
a checkpoint under ``device_loop``.

Every test needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere.  The
file imports no JAX; from the repository root on a GPU machine:

    python -m pytest tests/test_torch_cuda_digital.py -m cuda --noconftest
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grtpu_torch import Graph, Port, StreamExecutor  # noqa: E402
from grtpu_torch.digital.generic_mod_demod import GenericModem  # noqa: E402
from grtpu_torch.models.channel import ChannelModel  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def burst(modem, nbits, seed, cfo=0.0, noise=0.0):
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, nbits).astype(np.uint8)
    x = modem.modulate(bits).cpu().numpy()
    x = x * np.exp(1j * cfo * np.arange(len(x)))
    x = x + noise * (rng.randn(len(x)) + 1j * rng.randn(len(x)))
    return bits, x.astype(np.complex64)


def test_exact_chain_card_equals_cpu(dev):
    kw = dict(m=4, samples_per_symbol=4)
    cpu, card = GenericModem(device="cpu", **kw), GenericModem(device=dev, **kw)
    _, x = burst(cpu, 512, seed=1, cfo=0.003, noise=0.05)
    bc, dc = cpu.demodulate_diag(x)
    bg, dg = card.demodulate_diag(x)
    np.testing.assert_array_equal(bg, bc)
    assert abs(dg["freq"] - dc["freq"]) < 1e-5


def test_vmapped_bank_on_the_card(dev):
    modem = GenericModem(m=4, samples_per_symbol=2, chunked=True, device=dev)
    n, chans = 4096, 8
    xs, sent = [], []
    for c in range(chans):
        bits, x = burst(modem, n, seed=10 + c, noise=0.05)
        xs.append(x[:n] * np.exp(1j * (c - chans // 2) * 2e-5 * np.arange(n)))
        sent.append(bits)
    X = torch.from_numpy(np.stack(xs).astype(np.complex64)).to(dev)
    syms, nv, _, _, _ = torch.func.vmap(partial(modem._demod_dev,
                                                upto="all"))(X)
    for c in range(chans):
        one = modem._demod_dev(X[c])
        assert torch.equal(syms[c], one[0])
        assert int(nv[c]) == int(one[1]) > 1800


def test_channel_noise_resumes_under_device_loop(dev, tmp_path):
    def build():
        g = Graph()
        g.connect(g.add_input(Port(torch.complex64)),
                  ChannelModel(noise_voltage=0.2, frequency_offset=0.002),
                  g.add_output(Port(torch.complex64)))
        return StreamExecutor(g, chunk_size=1024, device=dev)

    x = torch.from_numpy((np.exp(0.1j * np.arange(8192))).astype(
        np.complex64)).to(dev)
    want = build().run(x)
    ex = build()
    first = ex.run(x[:4096], device_loop=True)
    path = str(tmp_path / "ckpt.npz")
    ex.save_checkpoint(path)
    resumed = build()
    resumed.load_checkpoint(path)
    second = resumed.run(x[4096:], device_loop=True)
    assert torch.equal(torch.cat([first, second]), want)

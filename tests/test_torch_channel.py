"""grtpu_torch's channel model and noise streams, held against grtpu on the
CPU, and BASELINE config #3 (mod -> channel -> demod) as a whole.

``ChannelModel`` at zero noise (CFO, multipath) agrees with grtpu to atol
1e-5 (tests/test_io_aux.py:260+'s scenarios); with epsilon != 1 it is held
to ``mmse_interpolate`` with a device bank, since grtpu's
``FractionalInterpolator`` cannot run in grtpu's executor (ROADMAP.md §3).
The port's noise is a counter-based stream (``ops.noise``), not grtpu's JAX
key stream: it is held to the distribution (mean, per-dimension variance,
the re/im split) and to resuming bit for bit from a checkpoint, eagerly and
under ``device_loop``; a checkpoint still does not cross the packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import grtpu  # noqa: E402
from grtpu.digital import generic_mod_demod as jgm  # noqa: E402
from grtpu.models import channel as jch  # noqa: E402
from grtpu.ops import mmse_interp as jmmse  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu_torch.blocks import gengen as tgen  # noqa: E402
from grtpu_torch.blocks import stream as tstream  # noqa: E402
from grtpu_torch.digital import generic_mod_demod as tgm  # noqa: E402
from grtpu_torch.models import channel as tch  # noqa: E402
from grtpu_torch.ops import noise  # noqa: E402


def out(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def chain(kind, *blocks, in_dtype="c", out_dtype="c"):
    pkg = grtpu if kind == "jax" else grtpu_torch
    dt = {"c": (jnp.complex64, torch.complex64), "b": (jnp.uint8, torch.uint8)}
    g = pkg.Graph()
    pad = (lambda d: pkg.runtime.block.Port(dt[d][0])) if kind == "jax" \
        else (lambda d: pkg.Port(dt[d][1]))
    g.connect(g.add_input(pad(in_dtype)), *blocks, g.add_output(pad(out_dtype)))
    return g


def executor(kind, g, chunk):
    pkg = grtpu if kind == "jax" else grtpu_torch
    kw = {"device": "cpu"} if kind == "torch" else {}
    return pkg.StreamExecutor(g, chunk_size=chunk, **kw)


def signal(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)


@pytest.mark.parametrize("kw", [
    dict(frequency_offset=0.01),
    dict(taps=np.array([1.0, 0.0, 0.4 + 0.2j], np.complex64)),
    dict(frequency_offset=-0.003, taps=np.array([0.9, 0.3j], np.complex64))],
    ids=["cfo", "multipath", "both"])
def test_channel_model_without_noise(kw):
    x = signal(2048, 1)
    ys = [out(executor(k, chain(k, mod.ChannelModel(**kw)), 512).run(x))
          for k, mod in (("jax", jch), ("torch", tch))]
    assert ys[1].dtype == np.complex64 and ys[1].shape == ys[0].shape
    np.testing.assert_allclose(ys[1], ys[0], atol=1e-5)


def test_channel_model_cfo_and_multipath_gates():
    """tests/test_io_aux.py:258-290 on the port."""
    cfo = 0.01
    x = np.ones(2048, np.complex64)
    y = out(executor("torch", chain("torch", tch.ChannelModel(
        noise_voltage=0.01, frequency_offset=cfo)), 512).run(x))
    dphi = np.angle(y[1:] * np.conj(y[:-1])).mean() / (2 * np.pi)
    assert abs(dphi - cfo) < 1e-3
    assert 0.001 < np.abs(np.abs(y) - 1.0).std() < 0.05
    imp = np.zeros(512, np.complex64)
    imp[10] = 1.0
    y = out(executor("torch", chain("torch", tch.ChannelModel(
        taps=np.array([1.0, 0.0, 0.4 + 0.2j], np.complex64))), 256).run(imp))
    np.testing.assert_allclose(y[10], 1.0, atol=1e-5)
    np.testing.assert_allclose(y[12], 0.4 + 0.2j, atol=1e-5)


def test_channel_model_epsilon():
    """epsilon != 1: the FractionalInterpolator in the chain, held to
    grtpu's mmse_interpolate with a device bank, chunk by chunk."""
    ratio, chunk = 1.25, 1000
    x = signal(3000, 2)
    got = out(executor("torch", chain("torch", tch.ChannelModel(
        epsilon=ratio)), chunk).run(x))
    nout = chunk // 5 * 4
    assert got.shape == (3 * nout,)
    pos = ratio * jnp.arange(nout, dtype=jnp.float32)
    bank = jnp.asarray(jmmse.mmse_taps())
    xp = np.concatenate([np.zeros(8, np.complex64), x])
    ref = np.concatenate([np.asarray(jmmse.mmse_interpolate(
        jnp.asarray(xp[c * chunk:(c + 1) * chunk + 8]), pos, bank))
        for c in range(3)])
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_awgn_statistics():
    """_AwgnAdder adds per-dimension std ``voltage``: both packages meet
    the same law at 2^16 samples; the port's draws are reproducible from
    the seed and differ between seeds."""
    v = 0.3
    x = np.zeros(1 << 16, np.complex64)

    def run(kind, mod, seed):
        return out(executor(kind, chain(kind, mod.ChannelModel(
            noise_voltage=v, noise_seed=seed)), 4096).run(x))

    for y in (run("torch", tch, 5), run("jax", jch, 5)):
        for part in (y.real, y.imag):
            assert abs(part.mean()) < 0.01
            assert abs(part.var() / v ** 2 - 1) < 0.03
        assert abs(np.mean(y.real * y.imag)) < 0.01 * v ** 2
    y = run("torch", tch, 5)
    np.testing.assert_array_equal(run("torch", tch, 5), y)
    assert not np.array_equal(run("torch", tch, 6), y)


def test_counter_stream_is_a_function_of_the_counter():
    """ops.noise: any span of the stream equals the same span drawn from
    the start, lanes and seeds are independent streams, and the uniforms
    stay inside (0, 1)."""
    whole = noise.uniform(3, torch.tensor(0), 4096, 0)
    part = noise.uniform(3, torch.tensor(1000), 96, 0)
    assert torch.equal(part, whole[1000:1096])
    assert 0.0 < float(whole.min()) and float(whole.max()) < 1.0
    assert abs(float(whole.mean()) - 0.5) < 0.02
    other = noise.uniform(3, torch.tensor(0), 4096, 1)
    assert abs(float(torch.corrcoef(torch.stack([whole, other]))[0, 1])) < 0.05
    assert not torch.equal(noise.uniform(4, torch.tensor(0), 4096, 0), whole)
    big = noise.uniform(3, torch.tensor(1 << 40), 8, 0)
    assert big.shape == (8,) and not torch.equal(big, whole[:8])
    z0, z1 = noise.normal_pair(3, torch.tensor(0), 1 << 16)
    for z in (z0, z1):
        assert abs(float(z.mean())) < 0.02 and abs(float(z.var()) - 1) < 0.03


def _noise_graph(kind_block):
    if kind_block == "source":
        g = grtpu_torch.Graph()
        g.connect(tgen.NoiseSource("gaussian", 0.5, 7, dtype=torch.complex64),
                  tstream.Copy(torch.complex64),
                  g.add_output(grtpu_torch.Port(torch.complex64)))
        return g
    return chain("torch", tch.ChannelModel(noise_voltage=0.2,
                                           frequency_offset=0.002))


@pytest.mark.parametrize("device_loop", [False, True],
                         ids=["eager", "device_loop"])
@pytest.mark.parametrize("kind_block", ["source", "channel"])
def test_noise_resumes_bit_for_bit(kind_block, device_loop, tmp_path):
    """A checkpoint taken after chunk k and loaded into a fresh executor
    continues the noise stream: the two halves equal one long run."""
    chunk = 256
    x = signal(6 * chunk, 3)

    def run(ex, part):
        if kind_block == "source":
            return out(ex.run(steps=3, device_loop=device_loop))
        return out(ex.run(x[part * 3 * chunk:(part + 1) * 3 * chunk],
                          device_loop=device_loop))

    whole = executor("torch", _noise_graph(kind_block), chunk)
    want = (out(whole.run(steps=6)) if kind_block == "source"
            else out(whole.run(x)))
    ex = executor("torch", _noise_graph(kind_block), chunk)
    first = run(ex, 0)
    path = str(tmp_path / "ckpt.npz")
    ex.save_checkpoint(path)
    resumed = executor("torch", _noise_graph(kind_block), chunk)
    resumed.load_checkpoint(path)
    np.testing.assert_array_equal(np.concatenate([first, run(resumed, 1)]),
                                  want)


def test_noise_checkpoints_do_not_cross_the_packages(tmp_path):
    """grtpu carries a JAX PRNG key, the port a count of samples drawn:
    loading either package's checkpoint into the other raises."""
    x = signal(512, 4)
    exs = {k: executor(k, chain(k, mod.ChannelModel(noise_voltage=0.1)), 256)
           for k, mod in (("jax", jch), ("torch", tch))}
    for k, ex in exs.items():
        ex.run(x)
        ex.save_checkpoint(str(tmp_path / f"{k}.npz"))
    with pytest.raises(ValueError, match="shape|does not match"):
        exs["torch"].load_checkpoint(str(tmp_path / "jax.npz"))
    with pytest.raises(ValueError, match="shape|does not match"):
        exs["jax"].load_checkpoint(str(tmp_path / "torch.npz"))


# ------------------------------------------------------ config #3 as a whole
def _loopback(kind, noise_voltage, cfo):
    gm = jgm if kind == "jax" else tgm
    ch = jch if kind == "jax" else tch
    return chain(kind, gm.GenericModBlock(m=4, samples_per_symbol=4),
                 ch.ChannelModel(noise_voltage=noise_voltage,
                                 frequency_offset=cfo,
                                 taps=np.array([1.0, 0.1j], np.complex64)),
                 gm.GenericDemodBlock(m=4, samples_per_symbol=4),
                 in_dtype="b", out_dtype="b")


def _ber(data, got, settle=2000, max_lag=40):
    """BER after the loops' acquisition (tests/test_vr_graph.py settles
    2000 bits), minimized over the alignment lag."""
    bits = np.unpackbits(data)
    n = min(len(got), len(bits)) - max_lag
    return min(float((got[settle:n] != bits[settle - lag:n - lag]).mean())
               for lag in range(max_lag))


def test_generic_loopback_graph_against_grtpu():
    """GenericModBlock -> ChannelModel (CFO, multipath, no noise) ->
    GenericDemodBlock: the port's bits equal grtpu's."""
    data = np.random.RandomState(5).randint(0, 256, 400).astype(np.uint8)
    ys = [out(executor(k, _loopback(k, 0.0, 5e-4), 200).run(data))
          for k in ("jax", "torch")]
    np.testing.assert_array_equal(ys[1], ys[0])
    assert _ber(data, ys[1]) == 0.0


def test_generic_loopback_graph_with_noise():
    """The same graph with AWGN: BER 0 after the settle, as
    tests/test_vr_graph.py:207-253 requires of its graph,
    and the device_loop run (each piece called on the CPU) equal to the
    eager run, noise included."""
    data = np.random.RandomState(6).randint(0, 256, 400).astype(np.uint8)
    eager = out(executor("torch", _loopback("torch", 0.05, 5e-4), 200)
                .run(data))
    loop = out(executor("torch", _loopback("torch", 0.05, 5e-4), 200)
               .run(data, device_loop=True))
    np.testing.assert_array_equal(loop, eager)
    assert _ber(data, eager) == 0.0

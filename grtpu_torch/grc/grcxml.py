"""Reader for the reference's ``.grc`` XML flowgraph format.

Port of ``grtpu.grc.grcxml`` over grtpu_torch's blocks (stdlib
``ElementTree``; nothing beyond the standard library, numpy and torch).  The
adapters build what grtpu's build, with the same defaults: a ``.grc`` file
cannot name an implementation, so its filters take ``impl="auto"``.

Analog of the GRC ingestion pipeline (SURVEY.md §3.5): ParseXML.py loads the
``<flow_graph><block><param>…`` tree (grc/base/ParseXML.py:60-90), the
Platform/FlowGraph model resolves block keys against grc/blocks/*.xml, and
Generator.py renders + runs a top_block script (grc/python/Generator.py:32-120).
Here the same XML is parsed into the grtpu Graph directly:

  * ``options`` / ``import`` / ``variable*`` / ``parameter`` / ``note``
    blocks form the evaluation environment (GRC param values are Python
    expressions over the variables, ``gr.*`` constants and ``firdes``).
  * every other block key goes through an adapter that translates the GRC
    param names (from the reference's grc/blocks/<key>.xml) into the
    corresponding grtpu block factory call.
  * GUI sinks map to the headless grtpu_torch.gui sinks; hardware I/O (audio,
    UHD) maps to capture/null stand-ins with a warning — the same
    substitution gr-run-waveform-style headless execution needs.

This makes actual reference flowgraphs (gnuradio-examples/grc/**.grc) run
unmodified: ``python -m grtpu_torch.grc run dial_tone.grc [--device cpu]``.
"""

from __future__ import annotations

import math
import warnings
import xml.etree.ElementTree as ET
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from grtpu_torch.runtime.block import Port, numpy_dtype
from grtpu_torch.runtime.graph import Graph

# ---------------------------------------------------------------- parsing
_META_PARAMS = {"id", "_enabled", "_coordinate", "_rotation", "alias",
                "affinity", "minoutbuf", "maxoutbuf", "comment"}

_STRUCTURAL = {"options", "import", "note", "variable", "variable_slider",
               "variable_chooser", "variable_text_box", "variable_check_box",
               "variable_static_text", "variable_config", "parameter",
               "notebook"}


def parse_grc(path: str):
    """XML -> (options, env_blocks, blocks, connections).

    blocks: [(key, id, {param: raw_value_string})]
    connections: [(src_id, src_port, dst_id, dst_port)]
    """
    root = ET.parse(path).getroot()
    if root.tag != "flow_graph":
        raise ValueError(f"{path}: not a GRC flow_graph XML")
    options: Dict[str, str] = {}
    env_blocks: List[Tuple[str, str, Dict[str, str]]] = []
    blocks: List[Tuple[str, str, Dict[str, str]]] = []
    enabled_ids = set()
    for b in root.findall("block"):
        key = b.findtext("key")
        params: Dict[str, str] = {}
        for p in b.findall("param"):
            params[p.findtext("key")] = p.findtext("value") or ""
        bid = params.get("id", key)
        if params.get("_enabled", "True") in ("False", "0"):
            continue
        enabled_ids.add(bid)
        clean = {k: v for k, v in params.items() if k not in _META_PARAMS}
        if key == "options":
            options = dict(clean, id=bid)
        elif key in _STRUCTURAL:
            env_blocks.append((key, bid, clean))
        else:
            blocks.append((key, bid, clean))
    connections = []
    for c in root.findall("connection"):
        s, d = c.findtext("source_block_id"), c.findtext("sink_block_id")
        if s in enabled_ids and d in enabled_ids:
            connections.append((s, int(c.findtext("source_key")),
                                d, int(c.findtext("sink_key"))))
    return options, env_blocks, blocks, connections


# ------------------------------------------------------------ eval env
def _make_gr_shim():
    """The ``gr`` namespace GRC value expressions reference (waveform /
    noise constants, item sizes, firdes)."""
    from grtpu_torch.utils import firdes

    return SimpleNamespace(
        # gr_sig_source waveforms -> grtpu SigSource waveform strings
        GR_COS_WAVE="cos", GR_SIN_WAVE="sin", GR_SQR_WAVE="square",
        GR_TRI_WAVE="triangle", GR_SAW_WAVE="sawtooth",
        GR_CONST_WAVE="const",
        # gr_noise_source kinds
        GR_GAUSSIAN="gaussian", GR_UNIFORM="uniform",
        GR_LAPLACIAN="laplacian", GR_IMPULSE="impulse",
        # item sizes (gr_io_signature arithmetic in expressions)
        sizeof_gr_complex=8, sizeof_float=4, sizeof_int=4,
        sizeof_short=2, sizeof_char=1,
        firdes=firdes,
    )


def build_env(env_blocks, overrides: Optional[Dict[str, Any]] = None):
    """Evaluate import/variable/parameter blocks into a namespace, the
    analog of the generated script's module globals."""
    from grtpu_torch.utils import firdes

    env: Dict[str, Any] = {
        "math": math, "np": np, "numpy": np, "pi": math.pi,
        "gr": _make_gr_shim(), "firdes": firdes,
        "trellis": _make_trellis_shim(),
        "True": True, "False": False, "None": None,
    }
    pending: Dict[str, str] = {}
    for key, bid, p in env_blocks:
        if key == "import":
            stmt = p.get("import", "")
            if "gnuradio" in stmt or "grc_gnuradio" in stmt or "wx" in stmt:
                continue  # shimmed names already present
            try:
                exec(stmt, env)  # noqa: S102 - GRC imports (math, numpy)
            except Exception as e:  # pragma: no cover
                warnings.warn(f"grc import {stmt!r} failed: {e}")
        elif key == "note":
            continue
        else:  # variable*, parameter
            pending[bid] = p.get("value", "0")
    if overrides:
        for k, v in overrides.items():
            env[k] = v
            pending.pop(k, None)
    # variables may reference each other in any order: fixed-point passes
    for _ in range(len(pending) + 1):
        progressed = False
        for bid, expr in list(pending.items()):
            try:
                env[bid] = eval(expr, env)  # noqa: S307 - GRC param exprs
            except Exception:
                continue
            del pending[bid]
            progressed = True
        if not pending:
            break
        if not progressed:
            raise ValueError(
                f"could not evaluate GRC variables: {sorted(pending)}")
    return env


def _ev(expr: str, env) -> Any:
    if expr is None or expr == "":
        return None
    return eval(expr, dict(env))  # noqa: S307 - GRC param expression


_DT = {"complex": torch.complex64, "float": torch.float32, "int": torch.int32,
       "short": torch.int16, "byte": torch.uint8}


def _dt(p, key="type", default="complex"):
    return _DT[p.get(key, default)]


def _np_dt(p, key="type", default="complex"):
    """The numpy dtype of a GRC type name (for data made on the host)."""
    return numpy_dtype(_dt(p, key, default))


# ------------------------------------------------------------- adapters
# key -> fn(params_raw, env) -> grtpu Block.  Each adapter evaluates the
# GRC param expressions it understands (param names match the reference's
# grc/blocks/<key>.xml) and calls the grtpu factory.
ADAPTERS: Dict[str, Callable] = {}


def adapter(*keys):
    def deco(fn):
        for k in keys:
            ADAPTERS[k] = fn
        return fn
    return deco


@adapter("gr_sig_source_x")
def _sig_source(p, env):
    from grtpu_torch.blocks.analog import SigSource
    return SigSource(_ev(p["samp_rate"], env), _ev(p["waveform"], env),
                     _ev(p["freq"], env), _ev(p["amp"], env),
                     _ev(p.get("offset", "0"), env), dtype=_dt(p))


@adapter("gr_noise_source_x")
def _noise_source(p, env):
    from grtpu_torch.blocks.gengen import NoiseSource
    return NoiseSource(_ev(p["noise_type"], env), _ev(p["amp"], env),
                       int(_ev(p.get("seed", "0"), env) or 0), dtype=_dt(p))


@adapter("gr_add_xx", "gr_sub_xx", "gr_multiply_xx", "gr_divide_xx",
         "gr_and_xx", "gr_or_xx", "gr_xor_xx")
def _nary(p, env, _key=None, **kw):
    from grtpu_torch.blocks import gengen
    cls = {"gr_add_xx": gengen.Add, "gr_sub_xx": gengen.Sub,
           "gr_multiply_xx": gengen.Multiply, "gr_divide_xx": gengen.Divide,
           "gr_and_xx": gengen.And, "gr_or_xx": gengen.Or,
           "gr_xor_xx": gengen.Xor}[kw["key"]]
    return cls(dtype=_dt(p), nin=int(_ev(p.get("num_inputs", "2"), env)),
               vlen=int(_ev(p.get("vlen", "1"), env)))


@adapter("gr_add_const_vxx", "gr_multiply_const_vxx")
def _const_op(p, env, **kw):
    from grtpu_torch.blocks import gengen
    cls = (gengen.AddConst if kw["key"] == "gr_add_const_vxx"
           else gengen.MultiplyConst)
    return cls(_ev(p["const"], env), dtype=_dt(p),
               vlen=int(_ev(p.get("vlen", "1"), env)))


@adapter("gr_throttle")
def _throttle(p, env, **kw):
    from grtpu_torch.blocks.stream import Throttle
    return Throttle(dtype=_dt(p), vlen=int(_ev(p.get("vlen", "1"), env)))


@adapter("gr_head", "gr_skiphead")
def _head(p, env, **kw):
    from grtpu_torch.blocks.stream import Head, SkipHead
    cls = Head if kw["key"] == "gr_head" else SkipHead
    return cls(int(_ev(p["num_items"], env)), dtype=_dt(p))


@adapter("gr_delay")
def _delay(p, env, **kw):
    from grtpu_torch.blocks.stream import Delay
    return Delay(int(_ev(p["delay"], env)), dtype=_dt(p))


@adapter("gr_repeat")
def _repeat(p, env, **kw):
    from grtpu_torch.blocks.stream import Repeat
    return Repeat(int(_ev(p["interp"], env)), dtype=_dt(p))


@adapter("gr_keep_one_in_n")
def _keep(p, env, **kw):
    from grtpu_torch.blocks.stream import KeepOneInN
    return KeepOneInN(int(_ev(p["n"], env)), dtype=_dt(p))


@adapter("gr_vector_source_x")
def _vsrc(p, env, **kw):
    from grtpu_torch.blocks.gengen import VectorSource
    data = np.asarray(_ev(p["vector"], env))
    return VectorSource(data.astype(_np_dt(p)),
                        repeat=bool(_ev(p.get("repeat", "True"), env)))


@adapter("gr_vector_sink_x", "gr_null_sink")
def _vsink(p, env, **kw):
    from grtpu_torch.blocks.gengen import NullSink, VectorSink
    cls = VectorSink if kw["key"] == "gr_vector_sink_x" else NullSink
    return cls(dtype=_dt(p), vlen=int(_ev(p.get("vlen", "1"), env)))


@adapter("gr_null_source")
def _nullsrc(p, env, **kw):
    from grtpu_torch.blocks.gengen import NullSource
    return NullSource(dtype=_dt(p))


@adapter("gr_file_source")
def _fsrc(p, env, **kw):
    from grtpu_torch.io.file import FileSource
    return FileSource(_ev(p["file"], env), dtype=_dt(p),
                      repeat=bool(_ev(p.get("repeat", "True"), env)))


@adapter("gr_file_sink")
def _fsink(p, env, **kw):
    from grtpu_torch.io.file import FileSink
    return FileSink(_ev(p["file"], env), dtype=_dt(p))


@adapter("gr_wavfile_sink")
def _wavsink(p, env, **kw):
    from grtpu_torch.io.file import WavFileSink
    return WavFileSink(_ev(p["file"], env),
                       int(_ev(p.get("samp_rate", "44100"), env)),
                       int(_ev(p.get("nchan", "1"), env)))


@adapter("gr_wavfile_source")
def _wavsrc(p, env, **kw):
    from grtpu_torch.io.file import WavFileSource
    return WavFileSource(_ev(p["file"], env),
                         repeat=bool(_ev(p.get("repeat", "False"), env)))


@adapter("audio_sink")
def _audio_sink(p, env, **kw):
    # hardware audio is a declared non-goal (SURVEY.md §7): capture instead
    from grtpu_torch.blocks.gengen import VectorSink
    warnings.warn("audio_sink: no audio hardware backend; capturing to a "
                  "VectorSink (read .captured / .data())")
    return VectorSink(dtype=torch.float32)


@adapter("audio_source")
def _audio_source(p, env, **kw):
    from grtpu_torch.blocks.gengen import NullSource
    warnings.warn("audio_source: no audio hardware backend; silence source")
    return NullSource(dtype=torch.float32)


@adapter("wxgui_fftsink2", "qtgui_sink_x")
def _fftsink(p, env, **kw):
    from grtpu_torch.gui import FftSink
    return FftSink(fft_size=int(_ev(p.get("fft_size", "1024"), env)),
                   sample_rate=_ev(p.get("samp_rate", "1.0"), env),
                   avg_alpha=float(_ev(p.get("avg_alpha", "0"), env) or 1.0),
                   dtype=_dt(p))


@adapter("wxgui_waterfallsink2")
def _wfsink(p, env, **kw):
    from grtpu_torch.gui import WaterfallSink
    return WaterfallSink(fft_size=int(_ev(p.get("fft_size", "512"), env)),
                         sample_rate=_ev(p.get("samp_rate", "1.0"), env),
                         dtype=_dt(p))


@adapter("wxgui_scopesink2")
def _scopesink(p, env, **kw):
    from grtpu_torch.gui import ScopeSink
    return ScopeSink(sample_rate=_ev(p.get("samp_rate", "1.0"), env),
                     dtype=_dt(p))


@adapter("wxgui_constellationsink2")
def _constsink(p, env, **kw):
    from grtpu_torch.gui import ConstSink
    return ConstSink()


@adapter("wxgui_numbersink2")
def _numsink(p, env, **kw):
    from grtpu_torch.gui import NumberSink
    return NumberSink(avg_alpha=float(_ev(p.get("avg_alpha", "0.05"), env)
                                      or 0.05), dtype=_dt(p))


@adapter("wxgui_histosink2", "gr_histo_sink_x")
def _histosink(p, env, **kw):
    from grtpu_torch.blocks.misc import HistoSink
    return HistoSink(int(_ev(p.get("num_bins", "64"), env)))


@adapter("gr_frequency_modulator_fc")
def _fmmod(p, env, **kw):
    from grtpu_torch.blocks.analog import FrequencyModulator
    return FrequencyModulator(_ev(p["sensitivity"], env))


@adapter("gr_phase_modulator_fc")
def _pmmod(p, env, **kw):
    from grtpu_torch.blocks.analog import PhaseModulator
    return PhaseModulator(_ev(p["sensitivity"], env))


@adapter("gr_quadrature_demod_cf")
def _qdemod(p, env, **kw):
    from grtpu_torch.blocks.analog import QuadratureDemod
    return QuadratureDemod(_ev(p["gain"], env))


@adapter("gr_agc2_xx")
def _agc2(p, env, **kw):
    from grtpu_torch.blocks.analog import Agc2
    return Agc2(_ev(p.get("attack_rate", "1e-1"), env),
                _ev(p.get("decay_rate", "1e-2"), env),
                _ev(p.get("reference", "1.0"), env),
                _ev(p.get("gain", "1.0"), env),
                _ev(p.get("max_gain", "0.0"), env), dtype=_dt(p))


@adapter("gr_costas_loop_cc")
def _costas(p, env, **kw):
    from grtpu_torch.digital.blocks import CostasLoop
    # 3.5 grc exposes raw alpha/beta gains; later vintages a loop bandwidth
    gains = None
    bw = 0.05
    if "alpha" in p and "beta" in p:
        gains = (float(_ev(p["alpha"], env)), float(_ev(p["beta"], env)))
    elif p.get("w") or p.get("loop_bw"):
        bw = float(_ev(p.get("w") or p["loop_bw"], env))
    return CostasLoop(bw, int(_ev(p["order"], env)), gains=gains)


@adapter("gr_fll_band_edge_cc")
def _fll(p, env, **kw):
    from grtpu_torch.digital.blocks import FllBandEdge
    gains = None
    bw = 0.035
    if "alpha" in p and "beta" in p:
        gains = (float(_ev(p["alpha"], env)), float(_ev(p["beta"], env)))
    elif p.get("w") or p.get("loop_bw"):
        bw = float(_ev(p.get("w") or p["loop_bw"], env))
    return FllBandEdge(float(_ev(p["samps_per_sym"], env)),
                       float(_ev(p["rolloff"], env)),
                       int(_ev(p["filter_size"], env)), bw, gains=gains)


@adapter("gr_clock_recovery_mm_xx", "digital_clock_recovery_mm_xx")
def _mm(p, env, **kw):
    from grtpu_torch.digital.blocks import ClockRecoveryMMCC, ClockRecoveryMMFF
    cls = (ClockRecoveryMMCC if p.get("type", "complex") == "complex"
           else ClockRecoveryMMFF)
    return cls(_ev(p["omega"], env), _ev(p["gain_omega"], env),
               _ev(p["mu"], env), _ev(p["gain_mu"], env),
               _ev(p.get("omega_relative_limit", "0.001"), env))


@adapter("gr_agc_xx")
def _agc(p, env, **kw):
    from grtpu_torch.blocks.analog import Agc
    return Agc(float(_ev(p.get("rate", "1e-4"), env)),
               float(_ev(p.get("reference", "1.0"), env)),
               float(_ev(p.get("gain", "1.0"), env)),
               float(_ev(p.get("max_gain", "0.0"), env)), dtype=_dt(p))


@adapter("gr_moving_average_xx")
def _movavg(p, env, **kw):
    from grtpu_torch.blocks.gengen import MovingAverage
    return MovingAverage(int(_ev(p["length"], env)),
                         _ev(p.get("scale", "1"), env), dtype=_dt(p))


@adapter("gr_interleaved_short_to_complex")
def _is2c(p, env, **kw):
    from grtpu_torch.blocks.convert import InterleavedShortToComplex
    return InterleavedShortToComplex()


@adapter("noaa_hrpt_pll_cf")
def _hrpt_pll(p, env, **kw):
    from grtpu_torch.models.noaa import HrptPll
    return HrptPll(float(_ev(p["alpha"], env)), float(_ev(p["beta"], env)),
                   float(_ev(p["max_offset"], env)))


@adapter("noaa_hrpt_deframer")
def _hrpt_deframer(p, env, **kw):
    from grtpu_torch.models.noaa import HrptDeframer
    return HrptDeframer()


@adapter("noaa_hrpt_decoder")
def _hrpt_decoder(p, env, **kw):
    from grtpu_torch.models.noaa import HrptDecoder
    return HrptDecoder(verbose=bool(_ev(p.get("verbose", "False"), env)),
                       output_files=bool(_ev(p.get("output", "False"), env)))


@adapter("gr_pfb_clock_sync_xxx")
def _pfbsync(p, env, **kw):
    from grtpu_torch.blocks.pfb import PfbClockSync
    gains = None
    loop_bw = 0.05
    if "alpha" in p:  # the 3.5 grc exposes raw loop gains
        gains = (float(_ev(p["alpha"], env)), float(_ev(p["beta"], env)))
    else:
        loop_bw = float(_ev(p["loop_bw"], env))
    init_phase = p.get("init_phase")
    return PfbClockSync(_ev(p["sps"], env), loop_bw,
                        np.asarray(_ev(p["taps"], env)),
                        int(_ev(p.get("filter_size", "32"), env)),
                        float(_ev(p.get("max_dev", "1.5"), env)),
                        gains=gains,
                        init_phase=(float(_ev(init_phase, env))
                                    if init_phase else None),
                        diag=True)  # grc block always exposes err/rate/phase


@adapter("blks2_dxpsk_mod", "blks2_dbpsk_mod", "blks2_dqpsk_mod",
         "blks2_d8psk_mod")
def _dxpsk_mod(p, env, **kw):
    from grtpu_torch.digital.generic_mod_demod import GenericModBlock
    m = {"dbpsk": 2, "dqpsk": 4, "d8psk": 8}[p.get("type", "dqpsk")] \
        if kw["key"] == "blks2_dxpsk_mod" else \
        {"blks2_dbpsk_mod": 2, "blks2_dqpsk_mod": 4,
         "blks2_d8psk_mod": 8}[kw["key"]]
    return GenericModBlock(
        m=m, samples_per_symbol=int(_ev(p["samples_per_symbol"], env)),
        excess_bw=float(_ev(p.get("excess_bw", "0.35"), env)),
        differential=True,
        gray_code=bool(_ev(p.get("gray_code", "True"), env)))


@adapter("blks2_packet_encoder")
def _pkt_enc(p, env, **kw):
    from grtpu_torch.digital.packet_blocks import PacketEncoder
    ac = p.get("access_code") or ""
    return PacketEncoder(
        p.get("type", "float"),
        int(_ev(p.get("payload_length", "0"), env) or 0) or 256,
        access_code=([int(c) for c in ac] if ac else None),
        samples_per_symbol=int(_ev(p.get("samples_per_symbol", "2"), env)),
        bits_per_symbol=int(_ev(p.get("bits_per_symbol", "1"), env)))


@adapter("blks2_packet_decoder")
def _pkt_dec(p, env, **kw):
    from grtpu_torch.digital.packet_blocks import PacketDecoder
    ac = p.get("access_code") or ""
    return PacketDecoder(
        p.get("type", "float"),
        int(_ev(p.get("payload_length", "0"), env) or 0) or 256,
        access_code=([int(c) for c in ac] if ac else None),
        threshold=int(_ev(p.get("threshold", "-1"), env) or -1))


@adapter("blks2_dxpsk_demod", "blks2_dbpsk_demod", "blks2_dqpsk_demod",
         "blks2_d8psk_demod")
def _dxpsk_demod(p, env, **kw):
    from grtpu_torch.digital.generic_mod_demod import GenericDemodBlock
    m = {"dbpsk": 2, "dqpsk": 4, "d8psk": 8}[p.get("type", "dqpsk")] \
        if kw["key"] == "blks2_dxpsk_demod" else \
        {"blks2_dbpsk_demod": 2, "blks2_dqpsk_demod": 4,
         "blks2_d8psk_demod": 8}[kw["key"]]
    return GenericDemodBlock(
        m=m, samples_per_symbol=int(_ev(p["samples_per_symbol"], env)),
        excess_bw=float(_ev(p.get("excess_bw", "0.35"), env)),
        differential=True,
        gray_code=bool(_ev(p.get("gray_code", "True"), env)))


@adapter("gr_fir_filter_xxx")
def _fir(p, env, **kw):
    from grtpu_torch.blocks.filter import FirFilter
    sig = {"ccc": "ccc", "ccf": "ccf", "fcc": "fcc", "fff": "fff",
           "fsf": "fsf", "scc": "scc"}[p.get("type", "fff")]
    return FirFilter(int(_ev(p["decim"], env)),
                     np.asarray(_ev(p["taps"], env)), sig)


@adapter("gr_interp_fir_filter_xxx")
def _ifir(p, env, **kw):
    from grtpu_torch.blocks.filter import InterpFirFilter
    return InterpFirFilter(int(_ev(p["interp"], env)),
                           np.asarray(_ev(p["taps"], env)),
                           p.get("type", "fff"))


@adapter("gr_freq_xlating_fir_filter_xxx")
def _xlate(p, env, **kw):
    from grtpu_torch.blocks.filter import FreqXlatingFirFilter
    return FreqXlatingFirFilter(
        int(_ev(p["decim"], env)), np.asarray(_ev(p["taps"], env)),
        _ev(p["center_freq"], env), _ev(p["samp_rate"], env),
        sig=p.get("type", "ccc"))


@adapter("gr_fft_filter_xxx")
def _fftfilter(p, env, **kw):
    from grtpu_torch.blocks.filter import FftFilter
    return FftFilter(int(_ev(p.get("decim", "1"), env)),
                     np.asarray(_ev(p["taps"], env)),
                     p.get("type", "ccc"))


@adapter("low_pass_filter", "high_pass_filter", "band_pass_filter",
         "band_reject_filter")
def _designed_filter(p, env, **kw):
    from grtpu_torch.blocks.filter import FirFilter, InterpFirFilter
    from grtpu_torch.utils import firdes
    gain = _ev(p.get("gain", "1"), env)
    fs = _ev(p["samp_rate"], env)
    win = _ev(p.get("win", "firdes.WIN_HAMMING"), env)
    beta = _ev(p.get("beta", "6.76"), env)
    key = kw["key"]
    if key == "low_pass_filter":
        taps = firdes.low_pass(gain, fs, _ev(p["cutoff_freq"], env),
                               _ev(p["width"], env), win, beta)
    elif key == "high_pass_filter":
        taps = firdes.high_pass(gain, fs, _ev(p["cutoff_freq"], env),
                                _ev(p["width"], env), win, beta)
    elif key == "band_pass_filter":
        taps = firdes.band_pass(gain, fs, _ev(p["low_cutoff_freq"], env),
                                _ev(p["high_cutoff_freq"], env),
                                _ev(p["width"], env), win, beta)
    else:
        taps = firdes.band_reject(gain, fs, _ev(p["low_cutoff_freq"], env),
                                  _ev(p["high_cutoff_freq"], env),
                                  _ev(p["width"], env), win, beta)
    t = p.get("type", "fir_filter_fff")
    sig = t.split("_")[-1]
    interp = int(_ev(p.get("interp", "1"), env))
    if "interp" in t:
        return InterpFirFilter(interp, taps, sig)
    return FirFilter(int(_ev(p.get("decim", "1"), env)), taps, sig)


@adapter("root_raised_cosine_filter")
def _rrc_filter(p, env, **kw):
    from grtpu_torch.blocks.filter import FirFilter, InterpFirFilter
    from grtpu_torch.utils import firdes
    taps = firdes.root_raised_cosine(
        _ev(p.get("gain", "1"), env), _ev(p["samp_rate"], env),
        _ev(p["sym_rate"], env), _ev(p["alpha"], env),
        int(_ev(p["ntaps"], env)))
    t = p.get("type", "fir_filter_ccf")
    sig = t.split("_")[-1]
    if "interp" in t:
        return InterpFirFilter(int(_ev(p.get("interp", "1"), env)), taps, sig)
    return FirFilter(int(_ev(p.get("decim", "1"), env)), taps, sig)


@adapter("blks2_pfb_arb_resampler_ccf", "blks2_pfb_arb_resampler_fff")
def _arb(p, env, **kw):
    from grtpu_torch.blocks.pfb import PfbArbResampler
    dt = torch.complex64 if kw["key"].endswith("ccf") else torch.float32
    taps = p.get("taps")
    taps = np.asarray(_ev(taps, env)) if taps else None
    return PfbArbResampler(_ev(p["rate"], env), taps,
                           int(_ev(p.get("size", "32"), env)), dtype=dt)


@adapter("blks2_pfb_channelizer_ccf")
def _chan(p, env, **kw):
    from grtpu_torch.blocks.pfb import PfbChannelizer
    taps = p.get("taps")
    taps = np.asarray(_ev(taps, env)) if taps else None
    return PfbChannelizer(int(_ev(p["nchan"], env)), taps,
                          int(float(_ev(p.get("osr", "1"), env))))


@adapter("blks2_rational_resampler_xxx")
def _rational(p, env, **kw):
    from grtpu_torch.blocks.filter import RationalResampler
    taps = p.get("taps")
    taps = np.asarray(_ev(taps, env)) if taps else None
    t = p.get("type", "ccc")
    return RationalResampler(int(_ev(p["interp"], env)),
                             int(_ev(p["decim"], env)), taps=taps, sig=t)


@adapter("blks2_wfm_rcv")
def _wfm(p, env, **kw):
    from grtpu_torch.models.fm import WfmRcv
    return WfmRcv(_ev(p["quad_rate"], env),
                  int(_ev(p["audio_decimation"], env)))


@adapter("blks2_wfm_rcv_pll")
def _wfm_pll(p, env, **kw):
    from grtpu_torch.models.fm import WfmRcvPll
    return WfmRcvPll(_ev(p["quad_rate"], env),
                     int(_ev(p["audio_decimation"], env)))


@adapter("gr_char_to_float", "gr_short_to_float", "gr_int_to_float",
         "gr_float_to_char", "gr_float_to_short", "gr_float_to_int",
         "gr_uchar_to_float", "gr_float_to_uchar", "gr_float_to_complex",
         "gr_complex_to_float", "gr_complex_to_real", "gr_complex_to_imag",
         "gr_complex_to_mag", "gr_complex_to_mag_squared",
         "gr_complex_to_arg", "gr_complex_to_interleaved_short",
         "gr_interleaved_short_to_complex")
def _convert(p, env, **kw):
    from grtpu_torch.blocks import convert
    cls = {
        "gr_char_to_float": convert.CharToFloatSigned,
        "gr_short_to_float": convert.ShortToFloat,
        "gr_int_to_float": convert.IntToFloat,
        "gr_float_to_char": convert.FloatToCharSigned,
        "gr_float_to_short": convert.FloatToShort,
        "gr_float_to_int": convert.FloatToInt,
        "gr_uchar_to_float": convert.UCharToFloat,
        "gr_float_to_uchar": convert.FloatToUChar,
        "gr_float_to_complex": convert.FloatToComplex,
        "gr_complex_to_float": convert.ComplexToFloat,
        "gr_complex_to_real": convert.ComplexToReal,
        "gr_complex_to_imag": convert.ComplexToImag,
        "gr_complex_to_mag": convert.ComplexToMag,
        "gr_complex_to_mag_squared": convert.ComplexToMagSquared,
        "gr_complex_to_arg": convert.ComplexToArg,
        "gr_complex_to_interleaved_short": convert.ComplexToInterleavedShort,
        "gr_interleaved_short_to_complex": convert.InterleavedShortToComplex,
    }[kw["key"]]
    return cls()


@adapter("gr_chunks_to_symbols_xx")
def _c2s(p, env, **kw):
    from grtpu_torch.blocks.gengen import ChunksToSymbols
    table = np.asarray(_ev(p["symbol_table"], env))
    return ChunksToSymbols(table, in_dtype=_dt(p, "in_type", "byte"),
                           out_dtype=_dt(p, "out_type", "complex"),
                           dimension=int(_ev(p.get("dimension", "1"), env)))


@adapter("random_source_x")
def _random_source(p, env, **kw):
    from grtpu_torch.blocks.gengen import VectorSource
    rng = np.random.default_rng(int(_ev(p.get("seed", "0"), env) or 0))
    data = rng.integers(int(_ev(p["min"], env)), int(_ev(p["max"], env)),
                        int(_ev(p["num_samps"], env)))
    return VectorSource(data.astype(_np_dt(p, default="byte")),
                        repeat=bool(_ev(p.get("repeat", "True"), env)))


@adapter("const_source_x")
def _const_source(p, env, **kw):
    from grtpu_torch.blocks.gengen import VectorSource
    c = _ev(p["const"], env)
    return VectorSource(np.asarray([c], _np_dt(p)), repeat=True)


@adapter("gr_channel_model")
def _channel_model(p, env, **kw):
    from grtpu_torch.models.channel import ChannelModel
    taps = _ev(p.get("taps", "1.0"), env)
    if np.isscalar(taps):
        taps = [taps]
    return ChannelModel(_ev(p.get("noise_voltage", "0.0"), env),
                        _ev(p.get("freq_offset", "0.0"), env),
                        _ev(p.get("epsilon", "1.0"), env),
                        np.asarray(taps, np.complex64),
                        int(_ev(p.get("seed", "3021"), env) or 3021))


@adapter("gr_constellation_decoder_cb")
def _const_decoder(p, env, **kw):
    from grtpu_torch.digital.blocks import ConstellationDecoder
    from grtpu_torch.digital.constellation import Constellation
    points = np.asarray(_ev(p["sym_position"], env), np.complex64)
    values = list(_ev(p.get("sym_value_out", "None"), env)
                  or range(len(points)))
    if list(values) != list(range(len(points))):
        warnings.warn("gr_constellation_decoder_cb: non-identity "
                      "sym_value_out folded into the decision map")
    c = Constellation(points, pre_diff_code=values)
    return ConstellationDecoder(c)


@adapter("blks2_error_rate")
def _error_rate(p, env, **kw):
    from grtpu_torch.blocks.misc import ErrorRate
    return ErrorRate(str(_ev(p.get("type", "'BER'"), env)),
                     int(_ev(p.get("win_size", "1000"), env)),
                     int(_ev(p.get("bits_per_symbol", "2"), env)))


@adapter("gr_packed_to_unpacked_xx")
def _p2u(p, env, **kw):
    from grtpu_torch.blocks.gengen import PackedToUnpacked
    return PackedToUnpacked(int(_ev(p.get("bits_per_chunk", "1"), env)),
                            dtype=_dt(p, default="byte"))


@adapter("gr_unpacked_to_packed_xx")
def _u2p(p, env, **kw):
    from grtpu_torch.blocks.gengen import UnpackedToPacked
    return UnpackedToPacked(int(_ev(p.get("bits_per_chunk", "1"), env)),
                            dtype=_dt(p, default="byte"))


@adapter("gr_vco_f")
def _vco(p, env, **kw):
    from grtpu_torch.blocks.analog import Vco
    return Vco(_ev(p["samp_rate"], env), _ev(p["sensitivity"], env),
               _ev(p.get("amplitude", "1"), env))


@adapter("blks2_cvsd_encode", "blks2_cvsd_decode")
def _cvsd(p, env, **kw):
    from grtpu_torch.vocoder.cvsd import CvsdDecodeBF, CvsdEncodeFB
    cls = CvsdEncodeFB if kw["key"].endswith("encode") else CvsdDecodeBF
    return cls(int(_ev(p.get("resample", "8"), env)),
               float(_ev(p.get("bw", "0.5"), env)))


@adapter("gr_pll_carriertracking_cc", "gr_pll_refout_cc", "gr_pll_freqdet_cf")
def _pll(p, env, **kw):
    from grtpu_torch.blocks import analog
    cls = {"gr_pll_carriertracking_cc": analog.PllCarrierTracking,
           "gr_pll_refout_cc": analog.PllRefout,
           "gr_pll_freqdet_cf": analog.PllFreqdet}[kw["key"]]
    # 3.5 grc exposes alpha/beta; our loops take loop bandwidth
    if "w" in p or "loop_bw" in p:
        bw = float(_ev(p.get("w") or p["loop_bw"], env))
    else:
        bw = float(np.sqrt(float(_ev(p.get("beta", "0.001"), env)) / 0.25))
    return cls(bw, _ev(p["max_freq"], env), _ev(p["min_freq"], env))


_HW_KEYS = {"uhd_usrp_source", "uhd_usrp_sink", "uhd_simple_source",
            "uhd_simple_sink", "usrp_simple_source_x", "usrp_simple_sink_x",
            "usrp2_source_xxxx", "usrp2_sink_xxxx", "video_sdl_sink"}


def make_block(key: str, bid: str, params: Dict[str, str], env):
    """Instantiate one GRC block via its adapter, falling back to the
    direct registry (grtpu-native specs can mix in registry keys).  A key in
    the registry's UNSUPPORTED_KEYS raises, naming the key and the reason."""
    from grtpu_torch.grc.registry import refuse_unsupported

    refuse_unsupported(key, bid)
    if key in _HW_KEYS:
        raise ValueError(
            f"{bid}: {key} needs radio hardware — substitute gr_file_source/"
            f"gr_udp_source (capture playback) to run this flowgraph")
    if key in ADAPTERS:
        fn = ADAPTERS[key]
        try:
            blk = fn(params, env, key=key)
        except TypeError:
            blk = fn(params, env)
        blk.name = bid
        return blk
    from grtpu_torch.grc.registry import BLOCK_REGISTRY
    if key in BLOCK_REGISTRY:
        kwargs = {k: _ev(v, env) for k, v in params.items()}
        blk = BLOCK_REGISTRY[key](**kwargs)
        blk.name = bid
        return blk
    raise KeyError(f"no adapter for GRC block key {key!r} (id {bid})")


def load_grc(path: str, overrides: Optional[Dict[str, Any]] = None):
    """.grc XML -> (Graph, byid, options, env).

    ``overrides`` replaces variable/parameter values (the analog of passing
    options to the generated script)."""
    options, env_blocks, blocks, connections = parse_grc(path)
    env = build_env(env_blocks, overrides)
    # resolve virtual_source/virtual_sink stream aliases
    # (grc_gnuradio/blks2: a named edge without a wire)
    vsink, vsrc = {}, {}
    real_blocks = []
    for key, bid, params in blocks:
        # stream_id is a raw label, not an expression
        if key == "virtual_sink":
            vsink[bid] = params.get("stream_id") or bid
        elif key == "virtual_source":
            vsrc[bid] = params.get("stream_id") or bid
        else:
            real_blocks.append((key, bid, params))
    stream_src = {}
    for s, sp, d, dp in connections:
        if d in vsink:
            stream_src[vsink[d]] = (s, sp)
    resolved = []
    for s, sp, d, dp in connections:
        if d in vsink:
            continue
        if s in vsrc:
            s, sp = stream_src[vsrc[s]]
        resolved.append((s, sp, d, dp))
    g = Graph(options.get("id", "grc_flowgraph"))
    byid: Dict[str, Any] = {}
    for key, bid, params in real_blocks:
        byid[bid] = make_block(key, bid, params, env)
    for s, sp, d, dp in resolved:
        g.connect((byid[s], sp), (byid[d], dp))
    # services (xmlrpc_server/client): in byid, never in the stream graph
    for b in byid.values():
        if getattr(b, "is_service", False):
            b.attach(env, byid, g)
    return g, byid, options, env


def run_grc(path: str, steps: int = 16, chunk_size: Optional[int] = None,
            overrides: Optional[Dict[str, Any]] = None, device=None):
    """Load + execute a .grc flowgraph (source-driven), flushing file
    sinks — the Generator.py generate-and-run analog.  chunk_size=None
    auto-sizes to the graph's decimation requirement.  Runs on ``device``,
    the card when not given."""
    from grtpu_torch.grc.flowgraph import flush_sinks
    from grtpu_torch.runtime.executor import StreamExecutor

    g, byid, options, env = load_grc(path, overrides)
    ex = StreamExecutor(g, chunk_size=chunk_size, device=device)
    ex.run(steps=steps)
    flush_sinks(byid)
    return ex, byid


# ------------------------------------------------------------- trellis keys
def _make_trellis_shim():
    """The 'trellis' namespace GRC expressions reference: metric/SISO
    constants and the interleaver(K, seed) constructor."""
    def interleaver(K, seed):
        from grtpu_torch.trellis.interleaver import Interleaver
        return Interleaver.random(int(K), int(seed))

    return SimpleNamespace(TRELLIS_EUCLIDEAN="euclidean",
                           TRELLIS_HARD_SYMBOL="hard_symbol",
                           TRELLIS_HARD_BIT="hard_bit",
                           TRELLIS_MIN_SUM="min_sum",
                           TRELLIS_SUM_PRODUCT="sum_product",
                           interleaver=interleaver)


def _wrap_ports(blk, in_dt, out_dt):
    """Wrap an int-native trellis block with casts so it presents the GRC
    stream types (short symbol streams in the reference flowgraphs)."""
    from grtpu_torch.runtime.graph import HierBlock
    from grtpu_torch.blocks.convert import Cast

    h = HierBlock(name=blk.name + "_w")
    g = h.graph
    pin = g.add_input(Port(in_dt))
    pout = g.add_output(Port(out_dt))
    g.connect(pin, Cast(in_dt, blk.in_ports[0].dtype), blk,
              Cast(blk.out_ports[0].dtype, out_dt), pout)
    return h


_TRELLIS_DT = {"b": torch.uint8, "s": torch.int16, "i": torch.int32}


@adapter("trellis_encoder_xx")
def _trellis_encoder(p, env, **kw):
    from grtpu_torch.trellis.blocks import TrellisEncoder
    from grtpu_torch.trellis.fsm import FSM

    fsm = FSM.from_file(_ev(p["fsm_args"], env))
    blk = TrellisEncoder(fsm, int(_ev(p.get("init_state", "0"), env)))
    t = p.get("type", "ss")
    return _wrap_ports(blk, _TRELLIS_DT[t[0]], _TRELLIS_DT[t[1]])


@adapter("trellis_viterbi_combined_xx")
def _trellis_viterbi_combined(p, env, **kw):
    from grtpu_torch.trellis.blocks import ViterbiCombined
    from grtpu_torch.trellis.fsm import FSM
    from grtpu_torch.runtime.graph import HierBlock
    from grtpu_torch.blocks.convert import Cast

    fsm = FSM.from_file(_ev(p["fsm_args"], env))
    table = np.asarray(_ev(p["table"], env))
    metric = str(_ev(p.get("metric_type", "'euclidean'"), env))
    cin = p.get("type", "c") == "c"
    blk = ViterbiCombined(fsm, int(_ev(p["block_size"], env)),
                          int(_ev(p.get("init_state", "-1"), env)),
                          int(_ev(p.get("final_state", "-1"), env)),
                          int(_ev(p.get("dim", "1"), env)),
                          table.astype(np.complex64 if cin else np.float32),
                          metric, complex_in=cin)
    out_dt = _TRELLIS_DT[p.get("out_type", "s")]
    h = HierBlock(name=blk.name + "_w")
    g = h.graph
    pin = g.add_input(Port(blk.in_ports[0].dtype))
    pout = g.add_output(Port(out_dt))
    g.connect(pin, blk, Cast(blk.out_ports[0].dtype, out_dt), pout)
    return h


@adapter("trellis_pccc_encoder_xx")
def _trellis_pccc_encoder(p, env, **kw):
    from grtpu_torch.trellis.blocks import PcccEncoder
    from grtpu_torch.trellis.fsm import FSM

    f1 = FSM.from_file(_ev(p["o_fsm_args"], env))
    f2 = FSM.from_file(_ev(p["i_fsm_args"], env))
    K = int(_ev(p.get("bl") or p["block_size"], env))
    inter = _ev(p.get("interleaver_args") or p["interleaver"], env)
    blk = PcccEncoder(f1, int(_ev(p.get("o_init_state", "0"), env) or 0),
                      f2, int(_ev(p.get("i_init_state", "0"), env) or 0),
                      inter, K)
    t = p.get("type", "ss")
    return _wrap_ports(blk, _TRELLIS_DT[t[0]], _TRELLIS_DT[t[1]])


@adapter("trellis_pccc_decoder_combined_xx")
def _trellis_pccc_decoder(p, env, **kw):
    from grtpu_torch.trellis.blocks import PcccDecoderCombined
    from grtpu_torch.trellis.fsm import FSM
    from grtpu_torch.runtime.graph import HierBlock
    from grtpu_torch.blocks.convert import Cast

    f1 = FSM.from_file(_ev(p["o_fsm_args"], env))
    f2 = FSM.from_file(_ev(p["i_fsm_args"], env))
    K = int(_ev(p["block_size"], env))
    inter = _ev(p["interleaver"], env)
    cin = p.get("type", "f") == "c"
    table = np.asarray(_ev(p["table"], env))
    blk = PcccDecoderCombined(
        f1, int(_ev(p.get("o_init_state", "0"), env) or 0),
        int(_ev(p.get("o_final_state", "-1"), env)),
        f2, int(_ev(p.get("i_init_state", "0"), env) or 0),
        int(_ev(p.get("i_final_state", "-1"), env)),
        inter, K, int(_ev(p.get("dim", "1"), env)),
        table.astype(np.complex64 if cin else np.float32),
        str(_ev(p.get("metric_type", "'euclidean'"), env)),
        float(_ev(p.get("scaling", "1.0"), env)),
        int(_ev(p.get("iterations", "10"), env)),
        sum_product=(str(_ev(p.get("siso_type", "'min_sum'"), env))
                     == "sum_product"),
        complex_in=cin)
    out_dt = _TRELLIS_DT[p.get("out_type", "s")]
    h = HierBlock(name=blk.name + "_w")
    g = h.graph
    pin = g.add_input(Port(blk.in_ports[0].dtype))
    pout = g.add_output(Port(out_dt))
    g.connect(pin, blk, Cast(blk.out_ports[0].dtype, out_dt), pout)
    return h


def _wrap_out_cast(blk, out_dt):
    """HierBlock casting only the output (metric-cost inputs stay float)."""
    from grtpu_torch.runtime.graph import HierBlock
    from grtpu_torch.blocks.convert import Cast

    h = HierBlock(name=blk.name + "_w")
    g = h.graph
    pin = g.add_input(Port(blk.in_ports[0].dtype))
    pout = g.add_output(Port(out_dt))
    g.connect(pin, blk, Cast(blk.out_ports[0].dtype, out_dt), pout)
    return h


@adapter("trellis_sccc_encoder_xx")
def _trellis_sccc_encoder(p, env, **kw):
    from grtpu_torch.trellis.blocks import ScccEncoder
    from grtpu_torch.trellis.fsm import FSM

    fo = FSM.from_file(_ev(p["o_fsm_args"], env))
    fi = FSM.from_file(_ev(p["i_fsm_args"], env))
    K = int(_ev(p.get("bl") or p["block_size"], env))
    inter = _ev(p.get("interleaver_args") or p["interleaver"], env)
    blk = ScccEncoder(fo, int(_ev(p.get("o_init_state", "0"), env) or 0),
                      fi, int(_ev(p.get("i_init_state", "0"), env) or 0),
                      inter, K)
    t = p.get("type", "ss")
    return _wrap_ports(blk, _TRELLIS_DT[t[0]], _TRELLIS_DT[t[1]])


@adapter("trellis_sccc_decoder_combined_xx")
def _trellis_sccc_decoder_combined(p, env, **kw):
    from grtpu_torch.trellis.blocks import ScccDecoderCombined
    from grtpu_torch.trellis.fsm import FSM

    fo = FSM.from_file(_ev(p["o_fsm_args"], env))
    fi = FSM.from_file(_ev(p["i_fsm_args"], env))
    K = int(_ev(p["block_size"], env))
    inter = _ev(p["interleaver"], env)
    cin = p.get("type", "c") == "c"
    table = np.asarray(_ev(p["table"], env))
    blk = ScccDecoderCombined(
        fo, int(_ev(p.get("o_init_state", "0"), env) or 0),
        int(_ev(p.get("o_final_state", "-1"), env)),
        fi, int(_ev(p.get("i_init_state", "0"), env) or 0),
        int(_ev(p.get("i_final_state", "-1"), env)),
        inter, K, int(_ev(p.get("dim", "1"), env)),
        table.astype(np.complex64 if cin else np.float32),
        str(_ev(p.get("metric_type", "'euclidean'"), env)),
        float(_ev(p.get("scaling", "1.0"), env)),
        int(_ev(p.get("iterations", "10"), env)),
        sum_product=(str(_ev(p.get("siso_type", "'min_sum'"), env))
                     == "sum_product"),
        complex_in=cin)
    return _wrap_out_cast(blk, _TRELLIS_DT[p.get("out_type", "s")])


@adapter("trellis_sccc_decoder_x")
def _trellis_sccc_decoder_plain(p, env, **kw):
    from grtpu_torch.trellis.blocks import ScccDecoder
    from grtpu_torch.trellis.fsm import FSM

    fo = FSM.from_file(_ev(p["o_fsm_args"], env))
    fi = FSM.from_file(_ev(p["i_fsm_args"], env))
    blk = ScccDecoder(
        fo, int(_ev(p.get("o_init_state", "0"), env) or 0),
        int(_ev(p.get("o_final_state", "-1"), env)),
        fi, int(_ev(p.get("i_init_state", "0"), env) or 0),
        int(_ev(p.get("i_final_state", "-1"), env)),
        _ev(p["interleaver"], env), int(_ev(p["block_size"], env)),
        int(_ev(p.get("iterations", "10"), env)),
        sum_product=(str(_ev(p.get("siso_type", "'min_sum'"), env))
                     == "sum_product"))
    return _wrap_out_cast(blk, _TRELLIS_DT[p.get("out_type", "s")])


@adapter("trellis_pccc_decoder_x")
def _trellis_pccc_decoder_plain(p, env, **kw):
    from grtpu_torch.trellis.blocks import PcccDecoder
    from grtpu_torch.trellis.fsm import FSM

    f1 = FSM.from_file(_ev(p["o_fsm_args"], env))
    f2 = FSM.from_file(_ev(p["i_fsm_args"], env))
    blk = PcccDecoder(
        f1, int(_ev(p.get("o_init_state", "0"), env) or 0),
        int(_ev(p.get("o_final_state", "-1"), env)),
        f2, int(_ev(p.get("i_init_state", "0"), env) or 0),
        int(_ev(p.get("i_final_state", "-1"), env)),
        _ev(p["interleaver"], env), int(_ev(p["block_size"], env)),
        int(_ev(p.get("iterations", "10"), env)),
        sum_product=(str(_ev(p.get("siso_type", "'min_sum'"), env))
                     == "sum_product"))
    return _wrap_out_cast(blk, _TRELLIS_DT[p.get("out_type", "s")])


@adapter("trellis_metrics_x")
def _trellis_metrics(p, env, **kw):
    from grtpu_torch.trellis.blocks import TrellisMetrics

    t = p.get("type", "f")
    cin = t == "c"
    table = np.asarray(_ev(p["table"], env))
    blk = TrellisMetrics(
        int(_ev(p["card"], env)), int(_ev(p.get("dim", "1"), env)),
        table.astype(np.complex64 if cin else np.float32),
        str(_ev(p.get("metric_type", "'euclidean'"), env)),
        complex_in=cin)
    if t in ("s", "i"):
        from grtpu_torch.runtime.graph import HierBlock
        from grtpu_torch.blocks.convert import Cast

        h = HierBlock(name=blk.name + "_w")
        g = h.graph
        pin = g.add_input(Port(_TRELLIS_DT[t]))
        pout = g.add_output(Port(blk.out_ports[0].dtype))
        g.connect(pin, Cast(_TRELLIS_DT[t], blk.in_ports[0].dtype), blk,
                  pout)
        return h
    return blk


@adapter("xmlrpc_server")
def _xmlrpc_server(p, env, **kw):
    from grtpu_torch.io.xmlrpc import XmlRpcServerService

    return XmlRpcServerService(p.get("addr", "localhost"),
                               int(_ev(p.get("port", "1234"), env)))


@adapter("xmlrpc_client")
def _xmlrpc_client(p, env, **kw):
    from grtpu_torch.io.xmlrpc import XmlRpcClientService

    return XmlRpcClientService(p.get("addr", "localhost"),
                               int(_ev(p.get("port", "1234"), env)),
                               p.get("callback", ""),
                               p.get("variable", ""))

"""Block registry for the declarative flowgraph compiler.

Port of ``grtpu.grc.registry``: every key grtpu registers maps to the
grtpu_torch counterpart of grtpu's class, except ``gr_peak_detector2_fb``,
which grtpu maps onto a block of another algorithm; the port refuses it
(:data:`UNSUPPORTED_KEYS`).

Analog of grc/blocks/*.xml (the 175 XML block descriptions) + the factory
resolution in grc/base/Block.py: maps flowgraph keys to block factories
with typed parameters.  Keys follow the reference's GRC naming where a
direct analog exists (gr_fir_filter_xxx, blks2_wfm_rcv, ...) with grtpu
aliases.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

BLOCK_REGISTRY: Dict[str, Callable] = {}


def register_block(key: str, factory: Callable = None):
    """Register a block factory under a flowgraph key (decorator-friendly)."""
    if factory is None:
        def deco(f):
            BLOCK_REGISTRY[key] = f
            return f
        return deco
    BLOCK_REGISTRY[key] = factory
    return factory


# GRC structural elements — compiled by grtpu.grc.flowgraph, not block
# factories (grc/python/Generator.py handles these the same way).
STRUCTURAL_KEYS = frozenset({
    "block_tree", "import", "note", "options", "parameter", "variable",
    "variable_config", "variable_function_probe", "pad_sink", "pad_source",
    "virtual_sink", "virtual_source",
})

# Keys refused, each with its reason: make_block (grcxml) and
# FlowgraphSpec.build raise an error naming both.
UNSUPPORTED_KEYS: dict = {
    "gr_peak_detector2_fb": (
        "gr_peak_detector2_fb (a peak detector over a moving average with a "
        "look-ahead window) has no counterpart here: grtpu maps the key "
        "onto PeakDetector, which computes gr_peak_detector_XX's different "
        "algorithm, so a flowgraph naming it would run silently wrong"),
}


def refuse_unsupported(key: str, bid=None):
    """Raise ValueError naming ``key`` and the reason it is refused, if it
    is in :data:`UNSUPPORTED_KEYS`."""
    if key in UNSUPPORTED_KEYS:
        where = f"{bid}: " if bid is not None else ""
        raise ValueError(f"{where}block key {key!r} is not supported: "
                         f"{UNSUPPORTED_KEYS[key]}")


_GRC_DTYPES = {"complex": torch.complex64, "float": torch.float32,
               "int": torch.int32, "short": torch.int16, "byte": torch.uint8}


def _tcp_factory(source: bool):
    """blks2_tcp_source/sink (grc/blocks/blks2_tcp_*.xml): GRC passes
    type/vlen/addr/port/server; vlen folds into the item count."""
    def make(addr="localhost", port=9000, server=True, type="complex",
             vlen=1, **_):
        from grtpu_torch.io import tcp
        from grtpu_torch.runtime.block import numpy_dtype
        dtype = numpy_dtype(_GRC_DTYPES.get(str(type), str(type)))
        cls = tcp.TcpSource if source else tcp.TcpSink
        return cls(str(addr), int(port), dtype=dtype,
                   server=bool(server in (True, "True", "1", 1)))
    return make


def _xmlrpc_factory(server: bool):
    """xmlrpc_server/client (grc/blocks/xmlrpc_*.xml).  The server wraps
    the flowgraph once it exists: GRC-loaded graphs call .register(tb)."""
    def make(addr="localhost", port=8080, **_):
        from grtpu_torch.io import xmlrpc_ctl
        if server:
            class _Deferred:
                """Server bound at tb.start(): register(tb) then serve."""
                def __init__(self):
                    self.addr, self.port = str(addr), int(port)
                    self.server = None

                def register(self, instance, start=True):
                    self.server = xmlrpc_ctl.XmlrpcServer(
                        instance, self.addr, self.port, start=start)
                    return self.server

                def stop(self):
                    if self.server is not None:
                        self.server.stop()
            return _Deferred()
        return xmlrpc_ctl.XmlrpcClient(str(addr), int(port))
    return make


def _filter_design_factory(design, default_win):
    """GRC's designed-filter wrapper blocks (grc/blocks/low_pass_filter.xml
    etc.): firdes design + FirFilter in one block."""
    def make(decim, gain, samp_rate, *band_args, win=None, beta=6.76,
             sig="fff", interp=None):
        from grtpu_torch.blocks.filter import FirFilter, InterpFirFilter
        from grtpu_torch.utils import firdes
        taps = design(gain, samp_rate, *band_args,
                      win if win is not None else default_win, beta)
        if interp:
            return InterpFirFilter(interp, taps, sig)
        return FirFilter(decim, taps, sig)
    return make


def _rrc_filter_factory():
    def make(decim, gain, samp_rate, sym_rate, alpha, ntaps, sig="ccf",
             interp=None):
        from grtpu_torch.blocks.filter import FirFilter, InterpFirFilter
        from grtpu_torch.utils import firdes
        taps = firdes.root_raised_cosine(gain, samp_rate, sym_rate, alpha,
                                         ntaps)
        if interp:
            return InterpFirFilter(interp, taps, sig)
        return FirFilter(decim, taps, sig)
    return make


def _random_source_factory():
    def make(dtype, minimum, maximum, num_samps, repeat=True, seed=0):
        import numpy as np
        from grtpu_torch.blocks.gengen import VectorSource
        rng = np.random.default_rng(seed)
        data = rng.integers(int(minimum), int(maximum), int(num_samps))
        return VectorSource(data.astype(np.float32), repeat=bool(repeat))
    return make


def _populate():
    from grtpu_torch.blocks import analog, convert, fftblk, filter as fblk, gengen
    from grtpu_torch.blocks import misc, pfb, stream
    from grtpu_torch.digital import blocks as dblocks, correlate, cpm, lfsr, pkt
    from grtpu_torch.fec import conv as fec_conv
    from grtpu_torch.io import file as iofile, msgio, udp
    from grtpu_torch.models import channel, fm
    from grtpu_torch.utils import firdes

    r = register_block
    # ---- gengen / arithmetic / sources / sinks -------------------------
    r("gr_add_xx", gengen.Add)
    r("gr_sub_xx", gengen.Sub)
    r("gr_multiply_xx", gengen.Multiply)
    r("gr_divide_xx", gengen.Divide)
    r("gr_add_const_vxx", gengen.AddConst)
    r("gr_multiply_const_vxx", gengen.MultiplyConst)
    r("gr_and_xx", gengen.And)
    r("gr_and_const_xx", gengen.AndConst)
    r("gr_or_xx", gengen.Or)
    r("gr_xor_xx", gengen.Xor)
    r("gr_not_xx", gengen.Not)
    r("gr_integrate_xx", gengen.Integrate)
    r("gr_moving_average_xx", gengen.MovingAverage)
    r("gr_argmax_xx", gengen.Argmax)
    r("gr_max_xx", gengen.Max)
    r("gr_mute_xx", gengen.Mute)
    r("gr_sample_and_hold_xx", gengen.SampleAndHold)
    r("gr_peak_detector_xb", gengen.PeakDetector)
    r("gr_vector_source_x", gengen.VectorSource)
    r("gr_vector_sink_x", gengen.VectorSink)
    r("gr_null_sink", gengen.NullSink)
    r("gr_null_source", gengen.NullSource)
    r("gr_noise_source_x", gengen.NoiseSource)
    r("gr_sig_source_x", analog.SigSource)
    r("const_source_x",
      lambda dtype, const: gengen.VectorSource([const], repeat=True))
    r("random_source_x", _random_source_factory())
    r("gr_chunks_to_symbols", gengen.ChunksToSymbols)
    r("gr_map_bb", gengen.MapBB)
    r("gr_packed_to_unpacked_xx", gengen.PackedToUnpacked)
    r("gr_unpacked_to_packed_xx", gengen.UnpackedToPacked)
    r("gr_unpack_k_bits_bb", gengen.UnpackKBits)
    r("gr_probe_signal_f", gengen.ProbeSignal)
    # ---- filters -------------------------------------------------------
    r("gr_fir_filter_xxx", fblk.FirFilter)
    r("gr_fft_filter_xxx", fblk.FftFilter)
    r("gr_interp_fir_filter_xxx", fblk.InterpFirFilter)
    r("gr_freq_xlating_fir_filter_xxx", fblk.FreqXlatingFirFilter)
    r("gr_rational_resampler_base_xxx", fblk.RationalResampler)
    r("blks2_rational_resampler_xxx", fblk.RationalResampler)
    r("gr_iir_filter_ffd", fblk.IirFilter)
    r("gr_single_pole_iir_filter_xx", fblk.SinglePoleIir)
    r("gr_hilbert_fc", fblk.Hilbert)
    r("gr_dc_blocker", fblk.DcBlocker)
    r("gr_filter_delay_fc", fblk.FilterDelay)
    r("gr_fractional_interpolator_xx", fblk.FractionalInterpolator)
    r("gr_goertzel_fc", fblk.Goertzel)
    r("low_pass_filter",
      _filter_design_factory(firdes.low_pass, firdes.Window.HAMMING))
    r("high_pass_filter",
      _filter_design_factory(firdes.high_pass, firdes.Window.HAMMING))
    r("band_pass_filter",
      _filter_design_factory(firdes.band_pass, firdes.Window.HAMMING))
    r("band_reject_filter",
      _filter_design_factory(firdes.band_reject, firdes.Window.HAMMING))
    r("root_raised_cosine_filter", _rrc_filter_factory())
    r("gr_pfb_channelizer_ccf", pfb.PfbChannelizer)
    r("blks2_pfb_channelizer", pfb.PfbChannelizer)
    r("blks2_analysis_filterbank", pfb.PfbChannelizer)
    r("gr_pfb_arb_resampler_ccf", pfb.PfbArbResampler)
    r("blks2_pfb_arb_resampler", pfb.PfbArbResampler)
    r("gr_pfb_synthesizer_ccf", pfb.PfbSynthesizer)
    r("gr_pfb_synthesis_filterbank", pfb.PfbSynthesizer)
    r("blks2_synthesis_filterbank", pfb.PfbSynthesizer)
    # ---- analog / loops / squelch / probes ------------------------------
    r("gr_quadrature_demod_cf", analog.QuadratureDemod)
    r("gr_frequency_modulator_fc", analog.FrequencyModulator)
    r("gr_phase_modulator_fc", analog.PhaseModulator)
    r("gr_vco_f", analog.Vco)
    r("gr_agc_xx", analog.Agc)
    r("gr_agc2_xx", analog.Agc2)
    r("gr_feedforward_agc_cc", analog.FeedForwardAgc)
    r("gr_pll_refout_cc", analog.PllRefout)
    r("gr_pll_carriertracking_cc", analog.PllCarrierTracking)
    r("gr_pll_freqdet_cf", analog.PllFreqdet)
    r("gr_simple_squelch_cc", analog.SimpleSquelch)
    r("gr_pwr_squelch_xx", analog.PwrSquelch)
    r("gr_ctcss_squelch_ff", misc.CtcssSquelch)
    r("blks2_standard_squelch", misc.StandardSquelch)
    r("gr_rms_xx", analog.Rms)
    r("gr_probe_avg_mag_sqrd_x", analog.ProbeAvgMagSqrd)
    r("gr_probe_density_b", misc.ProbeDensity)
    r("gr_probe_mpsk_snr_c", misc.ProbeMpskSnr)
    r("gr_dpll_bb", misc.DpllBB)
    r("gr_cpfsk_bc", misc.Cpfsk)
    r("gr_nlog10_ff", misc.NLog10)
    r("gr_transcendental", misc.Transcendental)
    r("gr_threshold_ff", misc.Threshold)
    r("gr_iqcomp_cc", misc.IqComp)
    r("blks2_error_rate", misc.ErrorRate)
    r("blks2_selector", misc.Selector)
    r("blks2_valve", misc.Valve)
    # ---- conversions -----------------------------------------------------
    r("gr_complex_to_mag", convert.ComplexToMag)
    r("gr_complex_to_mag_squared", convert.ComplexToMagSquared)
    r("gr_complex_to_arg", convert.ComplexToArg)
    r("gr_complex_to_real", convert.ComplexToReal)
    r("gr_complex_to_imag", convert.ComplexToImag)
    r("gr_complex_to_float", convert.ComplexToFloat)
    r("gr_complex_to_interleaved_short", convert.ComplexToInterleavedShort)
    r("gr_interleaved_short_to_complex", convert.InterleavedShortToComplex)
    r("gr_float_to_complex", convert.FloatToComplex)
    r("gr_float_to_char", convert.FloatToChar)
    r("gr_float_to_short", convert.FloatToShort)
    r("gr_float_to_uchar", convert.FloatToUChar)
    r("gr_char_to_float", convert.CharToFloat)
    r("gr_short_to_float", convert.ShortToFloat)
    r("gr_uchar_to_float", convert.UCharToFloat)
    r("gr_int_to_float", convert.IntToFloat)
    r("gr_conjugate_cc", convert.Conjugate)
    # ---- stream plumbing -------------------------------------------------
    r("gr_stream_to_vector", stream.StreamToVector)
    r("gr_vector_to_stream", stream.VectorToStream)
    r("gr_streams_to_vector", stream.StreamsToVector)
    r("gr_vector_to_streams", stream.VectorToStreams)
    r("gr_stream_to_streams", stream.StreamToStreams)
    r("gr_streams_to_stream", stream.StreamsToStream)
    r("gr_stream_mux", stream.StreamMux)
    r("gr_interleave", stream.Interleave)
    r("gr_deinterleave", stream.Deinterleave)
    r("gr_keep_one_in_n", stream.KeepOneInN)
    r("gr_repeat", stream.Repeat)
    r("gr_delay", stream.Delay)
    r("gr_skiphead", stream.SkipHead)
    r("gr_throttle", stream.Throttle)
    r("gr_head", stream.Head)
    r("gr_copy", stream.Copy)
    r("gr_kludge_copy", stream.Copy)
    r("gr_nop", stream.Copy)
    # ---- coding / framing / digital -------------------------------------
    r("digital_costas_loop_cc", dblocks.CostasLoop)
    r("digital_binary_slicer_fb", dblocks.BinarySlicer)
    r("gr_diff_encoder_bb", dblocks.DiffEncoder)
    r("gr_diff_decoder_bb", dblocks.DiffDecoder)
    r("gr_diff_phasor_cc", dblocks.DiffPhasor)
    r("digital_constellation_decoder_cb", dblocks.ConstellationDecoder)
    r("gr_mpsk_sync_cc", dblocks.MpskReceiver)
    r("gr_scrambler_bb", lfsr.Scrambler)
    r("gr_descrambler_bb", lfsr.Descrambler)
    r("gr_additive_scrambler_bb", lfsr.AdditiveScrambler)
    r("gr_glfsr_source_x", lfsr.GlfsrSource)
    r("gr_encode_ccsds_27_bb", fec_conv.EncodeCcsds27)
    r("gr_decode_ccsds_27_fb", fec_conv.DecodeCcsds27)
    r("gr_pn_correlator_cc", correlate.PnCorrelator)
    r("gr_simple_framer", correlate.SimpleFramer)
    r("gr_simple_correlator", correlate.SimpleCorrelator)
    from grtpu_torch.digital import packet_blocks as pblk
    r("blks2_packet_encoder", pblk.PacketEncoder)   # streaming form
    r("blks2_packet_decoder", pblk.PacketDecoder)
    r("blks2_mod_pkts", pkt.ModPkts)                # message-queue form
    r("blks2_demod_pkts", pkt.DemodPkts)
    # ---- fft / spectral --------------------------------------------------
    r("gr_fft_vxx", fftblk.FftVcc)
    r("blks2_logpwrfft_x", fftblk.LogPwrFft)
    r("blks2_stream_to_vector_decimator", fftblk.StreamToVectorDecimator)
    # ---- io --------------------------------------------------------------
    r("gr_file_source", iofile.FileSource)
    r("gr_file_sink", iofile.FileSink)
    r("gr_wavfile_source", iofile.WavFileSource)
    r("gr_wavfile_sink", iofile.WavFileSink)
    r("gr_udp_source", udp.UdpSource)
    r("gr_udp_sink", udp.UdpSink)
    r("gr_message_source", msgio.MessageSource)
    r("gr_message_sink", msgio.MessageStreamSink)
    r("blks2_tcp_source", _tcp_factory(source=True))
    r("blks2_tcp_sink", _tcp_factory(source=False))
    r("xmlrpc_server", _xmlrpc_factory(server=True))
    r("xmlrpc_client", _xmlrpc_factory(server=False))
    # ---- models ----------------------------------------------------------
    r("blks2_wfm_rcv", fm.WfmRcv)
    r("blks2_wfm_rcv_pll", fm.WfmRcvPll)
    r("blks2_wfm_tx", fm.WfmTx)
    r("blks2_nbfm_rx", fm.NbfmRx)
    r("blks2_nbfm_tx", fm.NbfmTx)
    r("blks2_am_demod_cf", fm.AmDemod)
    r("blks2_fm_demod_cf", fm.FmDemod)
    r("blks2_fm_deemph", fm.FmDeemph)
    r("blks2_fm_preemph", fm.FmPreemph)
    r("blks2_cvsd_encode", _cvsd("enc"))
    r("blks2_cvsd_decode", _cvsd("dec"))
    r("gr_channel_model", channel.ChannelModel)
    r("gr_pfb_clock_sync", pfb.PfbClockSync)
    from grtpu_torch.digital import generic_mod_demod as gmd
    r("blks2_gmsk_mod", gmd.GmskModBlock)
    r("blks2_gmsk_demod", gmd.GmskDemodBlock)
    r("blks2_dxpsk_mod", gmd.GenericModBlock)
    r("blks2_dxpsk_demod", gmd.GenericDemodBlock)
    # gr-noaa HRPT receive chain (gr-noaa/grc/noaa_hrpt_*.xml)
    from grtpu_torch.models import noaa
    r("noaa_hrpt_pll_cf", noaa.HrptPll)
    r("noaa_hrpt_deframer", noaa.HrptDeframer)
    r("noaa_hrpt_decoder", noaa.HrptDecoder)


def _cvsd(kind):
    def make(*a, **kw):
        from grtpu_torch.vocoder.cvsd import CvsdDecode, CvsdEncode
        return (CvsdEncode if kind == "enc" else CvsdDecode)(*a, **kw)
    return make


_populate()

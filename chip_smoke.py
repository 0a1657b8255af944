#!/usr/bin/env python3
"""Smoke run of grtpu_torch on one NVIDIA GPU: build, check, drive, report.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. Require a CUDA device, print its name and power limit, pin float32
     matmuls and convolutions to full precision (no TF32).
  2. Build the Hopper kernels from grtpu_torch/csrc (the FIR kernels, the
     two recursion kernels, the first-order IIR and the M&M clock
     recovery: one nvcc per source, seven started together, sm_90a).
  3. Hold each kernel against its plain PyTorch twin on the card, at the
     shapes the main path and the headline workload give it, and time both.
     Each case prints its bound (the larger of useful FLOP over the peak its
     mode can use and bytes over the memory rate) and the kernel's share of
     it; where one PyTorch call computes the same function
     (torch.nn.functional.conv1d), that call is timed in turns with the
     kernel as library_ms (it is used nowhere in grtpu_torch; the bf16x3
     cases are held against the call in float32, which meets their
     tolerance), and the decimating cases, which are small enough to sit on
     the host's launch cost, are timed again with both replayed from a CUDA
     graph; where a case runs on the tensor cores, the FMA route is forced
     on the same input and timed in turns too (fma_route_ms).  The host's
     cost of one fir_decim call at the main path's chunk is timed alone
     (batches of 1,000 calls on the host clock, no synchronize between them).
     The complex cases (fir_decim_c, ccf, and fir_decim_cc, ccc: the bank's
     64 channels as a complex64 stream, with the 155 taps and with them
     turned by a quarter of the band; 4 x 16k K200 d4; 4 x 8k K96 d2) must
     make exactly one launch a call, the kernels' complex mode reading the
     interleaved stream; their twin is cuda_fir.fir_decim_cplx_ref.  The
     same bank at decimation 1 (f32, bf16x3 and bf16, three tap sets,
     channel c on set c % 3 for both planes, and one set) must make one
     launch a call too, of the kernel cuda_fir._route names in its complex
     mode (fir_decim_mma_fwd in the bf16 modes, fir_decim_fwd in f32), held
     against the same twin; each prints its kernel, launches a call, error,
     bound, share and conv1d, and its time in turns with the stacked-planes
     path it replaces (forced), with the card's name and power limit.
     The first-order IIR's iir1_fwd (3b) at phase 4's chunk and at the
     benchmark's (FmDeemph's IirFilter at 32 kS/s, 1 x 8,192 and 1 x
     65,536, nff 2, K 49, through dsp.iir_filter) and at a bank (64 x 2^18,
     the same taps): one launch a call, within float32 rounding of its
     plain form (on the CPU for the chunks, on the card for the bank), both
     timed back to back and replayed from a CUDA graph, beside the bound
     (bytes).  From here on, the first two calls of iir1_fwd at each shape
     outside a CUDA-graph capture (the de-emphasis of every WBFM path
     below, at that path's shape) are held to the plain form on the CPU
     too (hold_iir1); the run ends by listing the shapes held, and phase
     4's must be among them.  The M&M clock recovery's mm_fwd (3c) at the
     DMR stream cell's chunk (4,320 samples and the block's 20 of history,
     radiobench's dmr_4fsk48k.stream loop) and at one chunk over the
     largest tile that shared memory holds (staged in tiles): one launch a
     call, torch.equal to the plain loop (loops._mm_exact) on the card in
     ys, n_valid and the state, timed back to back and replayed from a CUDA
     graph, beside the plain loop's replayed time (at the chunk) and the
     latency floor of its dependent steps (MM_STEP_FLOOR_NS a symbol; a
     request of the cell is 1,728 steps).
  4. Drive the main path: the WBFM receive chain (FM modulator -> quadrature
     demod -> 8x decimating FIR on the kernel -> de-emphasis) through Graph
     and StreamExecutor on the card, ~16 s of one station, checked for
     recovered-audio SNR and against the same chain on the plain path; the
     WBFM bank's audio FIR (64 channels x 2^18) through fir_decim in f32;
     and the headline workload (16 pipes x 2^20 samples x 16 stages of 256
     taps) through fir_cascade: the explicit cascade in f32 and bf16x3 and
     the composed 4097-tap filter in f32, in bf16x3 and on the bf16-resident
     stream.  Kernel launch counts are read around this phase only.
  5. Drive the DMR 4FSK receive slice on the card (its matched filter is a
     float32 Toeplitz matmul; the stream's clock recovery is the mm_fwd
     kernel, which the phase must launch):
     a. the burst bank at full width (benchmarks/dmr_bench.py: 128 channels
        x 110,592 samples, 10 samples/symbol, 110-tap RRC) through
        Fsk4Modem.demodulate_burst_bank; each channel carries back-to-back
        DMR bursts of distinct payloads, a CFO within +-50 Hz and 15 dB of
        AWGN.  Every burst sent must come back through find_bursts +
        extract_payload with payload BER < 0.02, and the pre-slicer levels
        must match the same call on CPU tensors to 1e-4; prints the bank's
        aggregate Msamples/s (CUDA events, median of 5 after a warm-up);
     b. ~1 s of DMR (48,000 samples, 15 dB) through the variable-rate
        executor (QuadratureDemod -> matched RRC -> ClockRecoveryMMFF ->
        FourLevelSlicer, chunk 4096), symbol error rate < 0.02 after the
        acquisition settle; and Fsk4Modem(chunked=True).demodulate on the
        same stream.  Prints both rates in symbols/s.
  6. Drive config #1 of BASELINE.json in full, and the FM family:
     a. a wideband capture made with numpy from a seed (2^23 complex64
        samples at 2.048 MS/s: an FM station, 1 kHz tone at 75 kHz deviation,
        at +400 kHz, a stronger one at -300 kHz, noise) through
        FreqXlatingFirFilter(8, low_pass(1, 2.048e6, 100e3, 50e3), 400e3) ->
        WfmRcv(256e3, 8, impl="kernel") in StreamExecutor, chunk 524,288
        (65,536 at the quad rate: the main path's kernel row).  Kernel
        launch counts are zeroed before and read after: fir_decim_mma_fwd
        must have been launched.  Gates: audio SNR > 30 dB against the
        de-emphasized tone; kernel path within 1e-4 of the impl="mxu" path.
        Prints Msamples/s of input.  The kernel path runs again at chunk
        65,536, and the audio SNR is printed at both chunks.  Then the tuner
        itself on the hand kernel (impl="kernel", the ccc mode) at
        radiobench's wbfm_rtl2048.file shape, chunk 4,194,304 under
        device_loop: per chunk two fir_decim_mma_fwd launches (tuner, audio
        FIR), one fir_decim_cc and one iir1_fwd, and nothing else; within
        1e-4 of the tuner on impl="mxu".  The rotator's carried phase at a
        centre of 400.1 kHz (at 400 kHz a chunk is a whole number of
        cycles, so a phase that never moved would pass) within 1e-6 rad of
        the exact closed form, -2 pi ((f_c N) mod f_s) / f_s worked out in
        rationals, after 2 and after 4 chunks.
     c. the same capture through the channel-select filter of a narrowband
        receiver, FirFilter(8, the tuner's 99 taps turned to +400 kHz,
        "ccc", impl="kernel"), chunk 524,288, eager and device_loop, two
        runs each: one fir_decim_* launch a chunk and nothing else (counts
        zeroed before each run, read after), device_loop torch.equal to
        eager, within 1e-4 of impl="mxu".  Prints Msamples/s of input.  The
        same filter at decimation 1 (a complex matched filter at full
        rate), FirFilter(1, the same taps, "ccc", impl="kernel"), with the
        same gates.
     b. NbfmTx(16e3, 64e3) -> NbfmRx(16e3, 64e3) on 2^20 audio samples of a
        1 kHz tone (tests/test_fm_models.py:89-116's gates); WfmRcvPll on a
        stereo composite (19 kHz pilot, 700 Hz left, 2200 Hz right), 2^21
        samples at 256 kS/s (tests/test_pager_misc.py:407-440's gates).
  7. Drive config #2, the polyphase filterbank (no hand kernel: cuBLAS
     float32 matmuls with TF32 off, cuFFT):
     a. channelize, 64 channels, 768-tap prototype, 2^20 samples + history
        (benchmarks/channelizer_bench.py:37): f32, bf16x3, bf16, and
        oversample 2 in f32 and bf16.  Gates: a tone in channel c comes out
        in channel c with > 95% of the power; bf16x3 within 1e-4 of f32
        relative to the peak, bf16 > 45 dB SNR; the card within 1e-5 of the
        CPU on a 2^14 prefix.  ms per call (CUDA events, median of 5).
     b. arb_resample, 64 rows x 2^17 at 3/2 and 64 x 132,300 at 160/147
        (benchmarks/resampler_bench.py:38-39): tone frequency within 1e-4,
        amplitude within 0.05; ms per call.
     c. PfbChannelizer(64) and PfbArbResampler(160/147), each a Graph through
        StreamExecutor over 2^22 samples: chunked output within 1e-5 of the
        one-call op; channelize -> synthesize round trip at 16 channels
        (NMSE < 0.1 at the best lag).
     d. the sequential loops, host-bound by construction: PfbClockSync on a
        12,000-sample BPSK stream through the variable-rate executor (chunk
        4000; under device_loop the device events of one replay of each
        captured graph are printed) and pfb_clock_sync_chunked on the same
        stream (decisions equal to the CPU run's); Agc and PllRefout over
        8,192 samples at chunk 2048.
  8. The executor's own cost a chunk (benchmarks/executor_overhead_bench.py's
     shape: 20 Copy blocks, chunk 4096, 256 chunks), eager and under
     device_loop.
  9. Config #3, the digital loopback (the PSK bank, the exact modem and
     BERT, the generic QPSK / GMSK graphs, the equalizers, the channel
     model's noise resumed from a checkpoint).
 10. Messages, stream tags, the packet layer and OFDM (no hand kernel; the
     phase's launch counts must stay 0):
     a. PacketEncoder -> bits -> CorrelateAccessCodeTag -> PacketDecoder
        over 2^16 floats (1024 packets of 256 bytes, chunk 4096) with
        add_tags on the input pad: the payloads, and the tags with their
        offsets and keys, identical eager, under device_loop and on the
        CPU; every packet passes its CRC; FramerSink and PacketSink deliver
        the same 32 messages (typed header included) in every mode;
     b. the OFDM receiver graph at benchmarks/ofdm_bench.py:35-80's shape
        (fft 64, 48 tones, cp 16, 24 frames of 8 data symbols, 20 dB, CFO
        0.002 rad/sample, chunk 4 frame spans): every frame found, BER <=
        1e-3, device_loop torch.equal to eager, bits equal to the CPU run,
        the channel estimate within 1e-4 of it;
     c. the same at GNU Radio 3.5's OFDM width (fft 512, 200 tones, cp 128:
        gr-digital/python/ofdm.py's option defaults);
     d. the receiver bank (ofdm_bench.py's bank_rate(64, 16, 16)):
        OfdmReceiver.apply vmapped over 64 channels, chunk 16 frame spans,
        eager and replayed from one CUDA graph; each channel's bits equal to
        its single-stream run through the executor; aggregate Msamples/s;
     e. OfdmPacketModem: 16 bursts through the receiver to parse_frames,
        every CRC passing but the one frame corrupted on purpose.
 11. Trellis coding, FEC and the ATSC 8-VSB receive chain (config #5), with
     the two recursion kernels viterbi_fwd and dfe_feedback_fwd:
     a. benchmarks/trellis_bench.py's Viterbi bank (FSM4, 4096 x 512,
        metrics from RandomState(0)) through the kernel's warp route and
        its block route, each torch.equal to its twin on the card; ms (one
        call and back to back), ns a dependent step, the first design's
        time ("was") and the target, Msymbols/s, bound and share; B=1
        through the kernel and through parallel=True (torch ops), same
        decisions;
     b. SCCC (FSM4 outer, the rate-2/3 inner, Interleaver.random(512, 666),
        8 iterations, 1024 blocks of clean metrics, torch ops): decoded bits
        equal to the bits sent; Msymbols/s;
     c. TrellisEncoder -> symbols -> TrellisMetrics -> ViterbiDecoder through
        StreamExecutor in both run modes: torch.equal across the modes,
        equal to the bits, viterbi_fwd launched in both;
     d. config #5 at benchmarks/atsc_bench.py's shape (1029 packets ->
        transmitter -> field sync mux -> pilot -> RRC -> 8-VSB passband at
        2.5 samples a symbol, 2.15M samples) -> AtscRfReceiver("lms2") on
        the card -> AtscReceiver, one warm-up run then five: >= 2 fields,
        >= 312 packets equal to ones sent, 0 uncorrectable (atsc_bench.py's
        gates); both kernels launched on the main path (counted on the last
        run); each kernel held to its twin on the inputs of its last
        launch in that run (the 12-phase Viterbi over both fields, on both
        routes, torch.equal; the DFE feedback over a whole field equal in
        decisions and within 1e-4), each with ms (one call with its host
        side, as the first design was timed, and calls back to back), ns a
        dependent step, the first design's time and the redesign's target,
        bound and share; the median per-stage times (each stage's function
        wrapped here, so the receivers take no timing argument) and input
        Msamples/s.  The DFE twin's step loop is replayed from CUDA graphs,
        a chunk of symbols a graph (launched one op at a time it takes ~50
        s a field).  The phase must end within 120 s.
 12. Drive the rest of the block library, the vocoders and the voice,
     pager and NOAA models on the card; they reach no hand kernel (launch
     counts zeroed before and printed after), and the phase must end
     within 150 s:
     a. graphs of misc, fftblk, oscope and selftest blocks, each eager and
        under device_loop (torch.equal) and against the CPU: LogPwrFft
        1024 on a tone at its bin; CtcssSquelch at a chunk of 1000 against
        its 1024 block; Threshold, DpllBB and Selector / Valve exact,
        IqComp within 1e-5; BurstTagger's tags equal in both modes and on
        the CPU, at the transitions; Lfsr32kSource -> CheckLfsr32k locked
        in both modes; OscopeSink's triggered frames;
     b. the vocoder banks at benchmarks/vocoder_bench.py's width, 64
        channels: G.721 encode of 2^14 samples (U = 16, 32, 64 steps a
        replay timed on a 1024-sample prefix, the fastest used), CVSD
        encode of 2^15, GSM 06.10 encode and decode of 50 frames; channel 0
        carries tests/data/vocoder_golden.npz's input and must give its
        codes and frames bit for bit, and the first 256 samples (2 GSM
        frames) of every channel must equal the same bank on the CPU; each
        prints Msamples/s, real-time channels (8 kS/s voice, 64 kS/s
        CVSD), us a step, ops a step (the dispatcher's count) and nodes a
        replay, and the graphs' capture seconds;
     c. Codec2, one second on the host (bits equal to the golden, decode
        above 50 dB against it), wall time; run(device_loop=True) over a
        graph with Codec2Encode must raise the error that names the block,
        and the eager run equal Codec2.encode;
     d. digital voice (10 GSM frames over GMSK) on the card and on the CPU:
        the decoded audio of both and its correlation with the source;
     e. two HRPT minor frames as PM baseband through HrptPll ->
        BinarySlicer -> HrptDeframer in both modes: every word equal to the
        words sent, HrptDecoder's report with 2 frames and 0 sequence
        errors; the FLEX numeric page of tests/test_pager_misc.py:197-234
        through PagerSlicer under device_loop.
 13. Config #1 from a flowgraph file and over UDP, the host I/O, the GUI
     sinks and the trace tools (launch counts zeroed before and printed
     after; the phase must end within 120 s):
     a. phase 6a's capture written to a .cfile and a JSON spec
        (gr_file_source -> gr_freq_xlating_fir_filter_xxx with phase 6a's
        tuner -> blks2_wfm_rcv {impl: kernel} -> gr_wavfile_sink, chunk
        524,288, 16 steps) run as users run it, ``python -m grtpu_torch.grc
        run spec.json`` in a subprocess on the default device, then
        in-process (FlowgraphSpec.build + StreamExecutor) eagerly and under
        run(device_loop=True), each twice.  Gates: fir_decim_mma_fwd and
        the de-emphasis' iir1_fwd launched 16 times a run each and nothing
        else, in all three; the modes
        torch.equal; the WAV's audio SNR > 30 dB and its int16 samples
        within 1 LSB of save_wav applied to phase 6a's audio.  Prints
        Msamples/s of input: the command line's wall, with its process
        start, its build (the file read included) and its run apart, and
        both in-process modes;
     b. the same chain as a GRC 3.5 .grc file written here (variables in
        any order, the taps as a firdes.low_pass expression, a virtual
        sink/source pair, a disabled block) through run_grc on the card:
        within 1e-5 of phase 6a's impl="mxu" audio, no FIR kernel launched
        (the adapters take impl auto), iir1_fwd 16 times;
     c. the WBFM receiver as a service: 2^20 samples at 256 kS/s sent over
        localhost UDP (UdpSink -> UdpSource.chunks(4096) -> stream() over
        WfmRcv(impl="kernel") -> UdpSink -> UdpSource): every item in, the
        audio equal to the in-memory run; the same stream from the capture
        file through NativeFileSource (the native ring and its file pump)
        torch.equal to it; native.available() must be True; Msamples/s and
        256 launches each;
     d. the GUI sinks fed from the card, each display array within 1e-5 of
        the same sink fed on the CPU (PNG sizes, or "not rendered: no
        matplotlib"); TracedExecutor one line a step; block_timings per
        block; validate_state empty; profile() writes a Chrome trace.
 14. The mesh executor and the parallel package on the card, meshes of
     logical shards on the one card (the phase must end within 120 s):
     a. config #1's bank (benchmarks/wfm_bench.py:35-40: 64 channels of 2^18
        samples at 256 kS/s, decimation 8; channel c an FM tone at 1000 +
        50 c Hz, channel 0 phase 4's) through MeshExecutor over
        WfmRcv(impl="kernel"), chunk 65,536, on (time, chan) meshes (1,1)
        and (2,2), eager and under run(device_loop=True), each run twice.
        Gates: every channel of both runs torch.equal to its own
        single-device StreamExecutor on (1,1), within atol 2e-6, rtol 1e-5
        on (2,2); the modes torch.equal; fir_decim_mma_fwd and iir1_fwd
        launched once a channel, time shard and chunk each (256 and 512 a
        run) and nothing else;
        the (2,2) kernel route within 1e-4 of the same mesh on mxu; channel
        0's audio SNR > 30 dB.  Prints Msamples/s of input of each mesh and
        mode (the second run), the route, the launches, and one
        fir_decim_mma_fwd call's ms at a shard's size beside the mxu route;
     b. ShardedWfmBank(nchannels=64) through jitted() (replayed from a CUDA
        graph) over three 64 x 2^18 steps on (2,2) against (1,1): audio
        within 2e-4, power rtol 1e-3, state 2e-4 at every step; ms a step;
     c. __graft_entry__.py::dryrun_multichip's sections on 4 logical shards
        at its own sizes, each within 1e-4 of the single-device executor:
        WBFM (and its device_loop run), the channelizer fan-out, the
        ClockRecoveryMMCC chain, the generic QPSK demod chain (eager: no
        PfbClockSync capture), the 3-output OfdmReceiver, the FIR pipeline
        and tap-parallel FIR, the PCCC bank (bits equal to those sent), the
        packet chain (payload round trip) and a checkpoint saved on (1,2)
        and restored on (2,2);
     d. time_sharded_mm over 4 spans of a 2^20-sample stream (grtpu's
        test_parallel.py gains): every splice's overlap agreement and the
        kept symbols' agreement with the continuous loop > 0.999.  The
        spans and the continuous loop run one recursion, so that gate holds
        the splice; the loop's first 4,096 symbols on the card must be
        torch.equal to the CPU's eager run of the same stream.
 15. grtpu's examples, ported (grtpu_torch/examples), each run through its
     main() as a user runs it (stream_server through serve()), on the card
     at the example's own sizes; the phase must end within 150 s:
     a. trellis_ber's five sweeps at -K 1024 -r 32 -i 10 -e 10 (the
        example's defaults at 10 dB), launch counts zeroed before each and
        read after: tcm and eq must launch viterbi_fwd (their (32, 1024, O)
        metrics in one call) and print the error counts of the CPU's run
        of the same arguments; sccc, pccc and turbo-eq must equal the CPU's
        on -r 2.  Wall s and symbols/s;
     b. wfm_demod on phase 4's station, 2^22 samples at 256 kS/s from a
        temporary .cfile, to a WAV: its audio SNR against the de-emphasized
        tone > 30 dB (the WAV's scale fitted); Msamples/s of input;
     c. stream_server's serve() on 2^20 samples over localhost UDP at its
        default chunk (8,192; the sender at most 2 chunks ahead of the
        audio): every sample served, the audio torch.equal to an in-memory
        run of the same graph on the card; Msamples/s;
     d. benchmark_tx_rx at its defaults (10 packets of 64 bytes, 15 dB) over
        gmsk, dbpsk and 4fsk: every line equal to the CPU's run, every
        packet intact over gmsk and dbpsk (grtpu's own example loses 4fsk's
        packet 9 at 15 dB, and so does the CPU run); packets/s;
     e. benchmark_ofdm, 4 frames flat and --multipath (every frame under 2%
        BER), and --curve (every frame found by the stream, burst and
        streaming BER < 0.02 from 16 dB); frames/s;
     f. digital_bert at 10 dB, cut to one chunk of 4,096 bits (its exact
        chain steps one symbol at a time; the default 4 x 2^14 bits would
        take 5-9 minutes, see BERT_ARGS): BER < 0.05 and equal to the
        CPU's run; symbols/s on both;
     g. howto_write_a_block's QA on the card; its tag block under step(),
        run(device_loop=True) and a 2-channel MeshExecutor (both modes):
        offsets [1, 4, 7] in every mode.
     Prints each example's wall s.
 16. Print one JSON line of per-kernel results (the nine kernels) and,
     last, the device line.

Every executor path of phases 4-11 runs twice eagerly and twice under
StreamExecutor.run(device_loop=True), each mode in an executor of its own,
on the same input: the device_loop outputs must be torch.equal to the eager
ones; both rates are printed (the second runs'), with the first device_loop
run's time and the host time its CUDA-graph captures took.  Under
device_loop the kernel launches are counted run by run: on the WBFM kernel
path and the tuner path fir_decim_mma_fwd and the de-emphasis' iir1_fwd
are launched once a chunk each (the first chunk eagerly, the rest in graph
replays) and nothing else.

Exits non-zero, printing no result, without a CUDA device or without the
grtpu_torch package beside this script.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from fractions import Fraction
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

QUAD_RATE = 256e3
AUDIO_DECIM = 8
MAIN_SAMPLES = 1 << 22
MAIN_CHUNK = 65536
# kernel-vs-twin tolerances on max|kernel - twin| / max|twin|: bf16 products
# are exact in float32, so the modes differ only in float32 summation order
# (and, for bf16, in which side of a bf16 rounding boundary a sum lands)
TOL = {"f32": 1e-5, "bf16x3": 1e-4, "bf16": 3e-2}
CHANNEL_TURN = 0.25    # a complex band-pass: low-pass taps turned by fs / 4
SNR_GATE_DB = 50.0
# published peaks of one H100 SXM (dense): what each precision mode can use.
# bf16x3 takes three bf16 products a tap.
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "bf16x3": 989e12}
PRODUCTS = {"f32": 1, "bf16": 1, "bf16x3": 3}
HBM_BYTES_PER_S = 3.35e12
# the DMR slice (benchmarks/dmr_bench.py:35-36 for the bank's shape)
DMR_CHANNELS = 128
DMR_SAMPLES = 110592
DMR_SPS = 10
DMR_FS = 48000.0
DMR_SNR_DB = 15.0
DMR_CFO_HZ = 50.0
DMR_STREAM = 48000
DMR_CHUNK = 4096
DMR_GATE = 0.02        # payload BER and symbol error rate (tests/test_digital.py)
DMR_LEVEL_TOL = 1e-4   # card vs CPU pre-slicer levels, absolute
DMR_SETTLE = 600       # symbols of loop acquisition discarded (TestFsk4)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, one warm-up)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """A kernel's milliseconds a call: the median over ``rounds`` of
    ``cuda_ms(fn, reps)``, calls back to back, so that the host's share of a
    call hides behind the card's work (a single call's time, median_ms,
    counts it where the call is short)."""
    return float(np.median([cuda_ms(fn, reps) for _ in range(rounds)]))


def median_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls, each timed by
    CUDA events, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def in_turns(a, b, reps_a: int, reps_b: int, rounds: int = 1):
    """Mean milliseconds of ``a()`` and of ``b()``, timed a, b, b, a; the
    median of ``rounds`` such rounds (a case that sits on the host's launch
    cost moves with whatever else the host is doing)."""
    ta, tb = [], []
    for _ in range(rounds):
        a1 = cuda_ms(a, reps_a)
        b1 = cuda_ms(b, reps_b)
        b2 = cuda_ms(b, reps_b)
        a2 = cuda_ms(a, reps_a)
        ta.append((a1 + a2) / 2)
        tb.append((b1 + b2) / 2)
    return float(np.median(ta)), float(np.median(tb))


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` replayed from one CUDA graph of ``reps``
    calls: the card's time for it without the host's cost of launching."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 3) / reps


def bound(flop: float, nbytes: float, precision: str):
    """(ms, "operations" or "bytes"): the least time the card could take for
    ``flop`` useful real FLOP (2 per tap and output) in ``precision`` and
    ``nbytes`` moved (each input and output byte once)."""
    ops_ms = flop * PRODUCTS[precision] / PEAK_FLOPS[precision] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def errors(got, ref):
    """(max abs error, max abs error / max |ref|) of two tensors."""
    d = (got - ref).abs().max().item()
    return d, d / max(ref.abs().max().item(), 1e-30)


def snr_db(ref: np.ndarray, est: np.ndarray) -> float:
    err = est - ref
    return 10 * np.log10((ref ** 2).sum() / max((err ** 2).sum(), 1e-30))


def align(ref, est, max_lag=256):
    """Align est to ref by cross-correlation (the chain's group delay)."""
    n = min(len(ref), len(est))
    r, e = ref[:n], est[:n]
    corr = [np.dot(r[: n - lag], e[lag:n]) for lag in range(max_lag)]
    lag = int(np.argmax(corr))
    return r[: n - lag], e[lag:n]


def same_outputs(a, b) -> bool:
    """torch.equal over one output tensor or a tuple of them."""
    import torch

    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(a, b))


def two_modes(torch, label, build, inputs, items, unit="Msamples/s",
              per=1e6, runs=2, cf=None):
    """Drive one executor path eagerly and under run(device_loop=True), each
    in an executor of its own made by ``build()``, ``runs`` runs each on the
    same input (the first device_loop run warms up and captures; the later
    ones replay).  Gate: every device_loop output torch.equal to the eager
    output of the same run.  Prints the rate of each mode's last run, the
    first device_loop run's time and the host time its captures took.
    With ``cf`` (grtpu_torch.ops.cuda_fir), the kernel launches of each
    device_loop run are counted (zeroed just before it, read just after)
    and returned as the fourth item.
    Returns (eager outputs, {mode: rate}, the device_loop executor,
    [launches of each device_loop run])."""
    outs, secs, exs, launches = {}, {}, {}, []
    for mode in ("eager", "device_loop"):
        ex = exs[mode] = build()
        outs[mode], secs[mode] = [], []
        for _ in range(runs):
            if cf is not None and mode == "device_loop":
                for name in cf.launches:
                    cf.launches[name] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = ex.run(*inputs, device_loop=mode == "device_loop")
            torch.cuda.synchronize()
            secs[mode].append(time.perf_counter() - t0)
            outs[mode].append(y)
            if cf is not None and mode == "device_loop":
                launches.append(dict(cf.launches))
    same = all(same_outputs(a, b)
               for a, b in zip(outs["eager"], outs["device_loop"]))
    loop = exs["device_loop"]._device_loop
    if callable(items):
        items = items(outs["eager"][-1])
    rate = {m: items / secs[m][-1] / per for m in secs}
    print(f"{label}: eager {rate['eager']:.2f} {unit}, device_loop "
          f"{rate['device_loop']:.2f} {unit} ({runs} runs each, rates of the "
          f"last; the first device_loop run took {secs['device_loop'][0]:.3f} "
          f"s, capturing {len(loop.graphs())} graphs "
          f"{loop.stats['capture_s']:.3f} s); device_loop torch.equal to eager: "
          f"{same}", flush=True)
    if not same:
        fail(f"{label}: the device_loop output differs from the eager output")
    if cf is not None:
        print(f"{label}: kernel launches of each device_loop run: {launches}",
              flush=True)
    return outs["eager"], rate, exs["device_loop"], launches


def decim1_route(torch, cf, fir, firdes, case, conv1d, xc, k, smi):
    """Phase 3's decimation-1 cases: fir_decim_c and fir_decim_cc on the
    WBFM bank's complex stream ``xc`` (64 x 2^18 outputs, ``k`` taps), one
    launch a call of the kernel cuda_fir._route names in its complex mode,
    held against fir_decim_cplx_ref.  Three tap sets: 64 % 3 = 1, so
    channel c's set c % 3 is not the set of its im plane's row in the
    stacked planes, which the planes path lays out first.  The one-set call
    is the same case at G = 1.  Each call is timed in turns with the
    stacked-planes path it replaces (forced), and in the bf16 modes with
    the FMA route (forced).  ccc: each set turned by a quarter of the band.
    The library call is conv1d grouped by channel (G = 3) or over the batch
    (G = 1)."""
    sets = np.stack([firdes.low_pass(1.0, QUAD_RATE, f, 4e3)
                     for f in (15e3, 12e3, 9e3)]).astype(np.float32)
    if sets.shape != (3, k):
        fail(f"the decimation-1 case's tap sets are {sets.shape}, not "
             f"(3, {k})")
    c = xc.shape[0]
    n = xc.shape[1] - (k - 1)
    rows = torch.arange(c, device=xc.device)

    def grouped_conv1d(tapsets):
        w = tapsets.to(xc.dtype)[rows % tapsets.shape[0]].flip(-1)[:, None]
        xin = xc[None]
        return lambda: torch.nn.functional.conv1d(xin, w, groups=c)

    real3 = torch.from_numpy(sets).to(xc.device)
    turned3 = torch.from_numpy(np.stack(
        [fir.rotate_taps(t, CHANNEL_TURN, 1.0) for t in sets])).to(xc.device)
    kernels = {"decim_mma": "fir_decim_mma_fwd", "decim_fma": "fir_decim_fwd",
               "tile": "fir_tile_fwd"}
    for sig, cplx, per, taps3 in (("c", cf.CCF, 2, real3),
                                  ("cc", cf.CCC, 4, turned3)):
        fn = getattr(cf, f"fir_decim_{sig}")
        for prec in ("f32", "bf16x3", "bf16"):
            route = cf._route(prec, 1, k, c, n, cplx=cplx)
            if route not in kernels:
                fail(f"fir_decim_{sig} at decimation 1 takes {route}")
            ms, planes = {}, {}
            for g, taps in ((3, taps3), (1, taps3[0])):
                case(f"fir_decim_{sig} 64x2^18 K{k} d1 G{g}", kernels[route],
                     prec, lambda: fn(xc, taps, 1, precision=prec),
                     lambda: cf.fir_decim_cplx_ref(xc, taps, 1, 0, n, prec,
                                                   cplx),
                     flop=2 * k * per * c * n,
                     nbytes=8 * xc.numel() + 4 * (per // 2) * k * g
                     + 8 * c * n,
                     reps=5, library=grouped_conv1d(taps) if g > 1
                     else conv1d(xc, taps, 1),
                     lib_reps=3, launches_a_call=1, route=route,
                     fma=None if prec == "f32" else
                     (lambda: cf._launch_tile(xc, taps, 1, 0, n, prec,
                                              _fma=True, cplx=cplx)))
                ms[g], planes[g] = in_turns(
                    lambda: fn(xc, taps, 1, precision=prec),
                    lambda: cf._decim_complex(xc, taps, 1, prec, cplx,
                                              _force_planes=True),
                    5, 5, rounds=3)
            print(f"decim1 fir_decim_{sig} 64x2^18 K{k} {prec}: "
                  f"{kernels[route]} 1 launch a call; G=3 {ms[3]:.4f} ms "
                  f"(planes {planes[3]:.4f}), G=1 {ms[1]:.4f} ms (planes "
                  f"{planes[1]:.4f}) a call, each in turns with the planes "
                  f"path, median of 3 rounds; {smi}", flush=True)


def check_kernels(torch, cf, fir, firdes, _build):
    """Phase 3: every kernel case against its twin; returns per-case rows."""
    dev = torch.device("cuda")
    rows = []
    smi = gpu_line()

    def case(name, kernel, precision, run, twin, flop, nbytes, reps=10,
             twin_reps=3, library=None, lib_reps=10, fma=None, graphed=False,
             rounds=1, launches_a_call=None, route=None):
        before = dict(cf.launches)
        got = run()
        launched = {n: cf.launches[n] - before[n] for n in cf.launches
                    if cf.launches[n] != before[n]
                    and n not in cf.MODE_COUNTS}
        if launches_a_call and launched != {kernel: launches_a_call}:
            fail(f"{name} {precision}: one call launched {launched}, "
                 f"expected {kernel} {launches_a_call} times")
        ref = twin()
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            fail(f"{name} {precision}: shape {tuple(got.shape)} vs "
                 f"{tuple(ref.shape)} or non-finite output")
        abs_err, rel_err = errors(got, ref)
        bound_ms, bound_by = bound(flop, nbytes, precision)
        times = []
        library_ms = fma_ms = g_ms = g_fma = None
        if library is not None:
            lib_out = library().reshape(ref.shape)
            lib_err = errors(lib_out if lib_out.is_complex() else lib_out.float(),
                             ref)[1]
            if not lib_err <= TOL[precision]:
                fail(f"{name} {precision}: the library call is off its twin "
                     f"by {lib_err:.3e}: it does not compute this function")
            ms, library_ms = in_turns(run, library, reps, lib_reps, rounds)
            times.append(ms)
        if fma is not None:
            ms, fma_ms = in_turns(run, fma, reps, reps, rounds)
            times.append(ms)
        if not times:
            times.append(cuda_ms(run, reps))
        ms = sum(times) / len(times)
        plain_ms = cuda_ms(twin, twin_reps)
        in_graph = ""
        if graphed:
            # small cases sit on the host's launch cost: the card's own time
            g_ms = graph_ms(run, 20)
            in_graph = (f" in_a_graph: kernel_ms={g_ms:.4f} "
                        f"library_ms={graph_ms(library, 20):.4f}")
            if fma is not None:
                g_fma = graph_ms(fma, 20)
                in_graph += f" fma_route_ms={g_fma:.4f}"
        ok = rel_err <= TOL[precision]
        lib = ("none" if library_ms is None else
               f"{library_ms:.4f} (conv1d, rel_err vs twin {lib_err:.1e})")
        print(f"kernel {name:28s} {kernel:19s} {precision:7s} "
              + (f"launches_a_call={sum(launched.values())} "
                 if launches_a_call else "")
              + (f"route={route} " if route else "")
              + f"max_rel_err={rel_err:.3e} (tol {TOL[precision]:g}) "
              f"max_abs_err={abs_err:.3e} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
              f"share_of_bound={bound_ms / ms:.3f} library_ms={lib}"
              + ("" if fma_ms is None else f" fma_route_ms={fma_ms:.4f}")
              + in_graph
              + f" {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name} {precision}: kernel disagrees with its twin")
        # the route taken must be the faster one; where both sit on the
        # host's launch cost, by the card's own time
        pair = (g_ms, g_fma) if graphed and fma is not None else (ms, fma_ms)
        if fma_ms is not None and not pair[0] < pair[1]:
            fail(f"{name} {precision}: the tensor-core route ({pair[0]:.4f} "
                 f"ms) is not faster than the FMA route ({pair[1]:.4f} ms)")
        rows.append(dict(case=name, kernel=kernel, precision=precision,
                         max_abs_err=abs_err, max_rel_err=rel_err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms,
                         fma_ms=fma_ms, graph_ms=g_ms))
        return got

    def conv1d(x, taps, decim):
        """The one PyTorch call that computes a single-stage FIR (cuDNN;
        TF32 is off): taps flipped, stride = decim; on a complex64 stream
        the taps are cast to complex64.  Timed only.  On float32 tensors it
        serves the f32 and the bf16x3 cases alike."""
        w = taps.to(x.dtype).flip(-1)[None, None, :]
        xin = x[:, None, :]
        return lambda: torch.nn.functional.conv1d(xin, w, stride=decim)

    # fir_decim at the main path's shape: one 65,536-sample chunk plus
    # WfmRcv's 192 history samples, 193 taps, decimate by 8, bf16x3 (the
    # FirFilter(impl="kernel") default)
    rng = np.random.RandomState(0)
    audio_rate = QUAD_RATE / AUDIO_DECIM
    taps193 = firdes.low_pass(1.0, QUAD_RATE, audio_rate / 2 - 1e3,
                              audio_rate / 10, firdes.Window.HAMMING)
    xm = torch.from_numpy(rng.randn(1, MAIN_CHUNK + len(taps193) - 1)
                          .astype(np.float32)).to(dev)
    t193 = cf._tapsets(taps193, dev)
    nout = MAIN_CHUNK // AUDIO_DECIM

    def chunk():
        return cf.fir_decim(xm, t193, AUDIO_DECIM, precision="bf16x3")

    case("fir_decim 1x65536 K193 d8", "fir_decim_mma_fwd", "bf16x3", chunk,
         lambda: cf.fir_tile_ref(xm, t193, AUDIO_DECIM, 0, nout, "bf16x3"),
         flop=2 * len(taps193) * nout,
         nbytes=4 * (xm.numel() + len(taps193) + nout),
         library=conv1d(xm, t193[0], AUDIO_DECIM), graphed=True,
         # 200 calls, five rounds: at this size the eager time is the host's
         # issue rate, which the first few calls after an idle spell do not
         # show and which a busy host moves
         reps=200, lib_reps=200, rounds=5,
         fma=lambda: cf._launch_tile(xm, t193, AUDIO_DECIM, 0, nout, "bf16x3",
                                     _fma=True))
    # what one such call costs the host: the wrapper's Python and the launch
    host_us = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            chunk()
        host_us.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    print(f"host cost fir_decim 1x65536 K193 d8 bf16x3: "
          f"{float(np.median(host_us)):.2f} us per call (median of 5 batches "
          f"of 1000 calls, host clock, no synchronize: "
          f"{' '.join(f'{v:.2f}' for v in host_us)})", flush=True)

    # fir_decim at the WBFM bank shape (benchmarks/wfm_bench.py: 64 ch x
    # 2^18 samples at 256 kS/s, 155-tap decimate-by-8 audio FIR)
    taps155 = firdes.low_pass(1.0, QUAD_RATE, 15e3, 4e3)
    k = len(taps155)
    x = torch.from_numpy(rng.randn(64, (1 << 18) + k - 1).astype(np.float32)).to(dev)
    t155 = cf._tapsets(taps155, dev)
    nout = (1 << 18) // AUDIO_DECIM
    x16 = x.to(torch.bfloat16)
    bank = {"x": x, "taps": t155}
    for prec in ("bf16x3", "f32", "bf16"):
        bank[prec] = case(
            "fir_decim 64x2^18 K155 d8",
            "fir_decim_fwd" if prec == "f32" else "fir_decim_mma_fwd", prec,
            lambda: cf.fir_decim(x, t155, AUDIO_DECIM, precision=prec),
            lambda: cf.fir_tile_ref(x, t155, AUDIO_DECIM, 0, nout, prec),
            flop=2 * k * 64 * nout, nbytes=4 * (x.numel() + k + 64 * nout),
            library=conv1d(x16 if prec == "bf16" else x, t155[0],
                           AUDIO_DECIM), graphed=True,
            fma=None if prec == "f32" else
            (lambda: cf._launch_tile(x, t155, AUDIO_DECIM, 0, nout, prec,
                                     _fma=True)))
    del x16
    # the same filter in its ccf and ccc forms at the bank's width: 64
    # complex channels, one launch of the kernel's complex mode reading the
    # interleaved stream (ccc: the taps turned by a channel offset of a
    # quarter of the band); the library call is conv1d on the complex64
    # stream, the twin the complex modes' plain form
    xc = torch.complex(x, x.flip(0))
    t155c = torch.from_numpy(fir.rotate_taps(taps155, CHANNEL_TURN, 1.0)
                             ).to(dev)
    for sig, taps_c, cplx, per in (("c", t155[0], cf.CCF, 2),
                                   ("cc", t155c, cf.CCC, 4)):
        for prec in ("bf16x3", "f32"):
            case(f"fir_decim_{sig} 64x2^18 K155 d8",
                 "fir_decim_fwd" if prec == "f32" else "fir_decim_mma_fwd",
                 prec,
                 lambda: getattr(cf, f"fir_decim_{sig}")(
                     xc, taps_c, AUDIO_DECIM, precision=prec),
                 lambda: cf.fir_decim_cplx_ref(xc, taps_c, AUDIO_DECIM, 0,
                                               nout, prec, cplx),
                 flop=2 * k * per * 64 * nout,
                 nbytes=8 * xc.numel() + 4 * (per // 2) * k + 8 * 64 * nout,
                 reps=5, library=conv1d(xc, taps_c, AUDIO_DECIM), lib_reps=5,
                 launches_a_call=1,
                 fma=None if prec == "f32" else
                 (lambda: cf._launch_tile(xc, taps_c, AUDIO_DECIM, 0, nout,
                                          prec, _fma=True, cplx=cplx)))
    decim1_route(torch, cf, fir, firdes, case, conv1d, xc, k, smi)
    del xc

    # short filters at decimation 8 and 2: the two decimating routes side by
    # side around cuda_fir._dm_min_taps (timed only, from a CUDA graph)
    for kk in (16, 32, 64, 128):
        tk = cf._tapsets(np.random.RandomState(kk).randn(kk) / kk, dev)
        for d in (8, 2):
            xs = x[:, :(1 << 15) * d + kk - 1].contiguous()
            for prec in ("bf16", "bf16x3"):
                plan = cf._decim_launch(
                    "fir_decim_mma_fwd", 64, xs.shape[1], 1, kk, d, 0,
                    1 << 15, prec, cf._decim_mma_plan(prec, d, kk, 64,
                                                      1 << 15))
                tensor_ms = graph_ms(
                    lambda: cf._launch_tile(xs, tk, d, 0, 1 << 15, prec,
                                            _plan=plan), 20)
                fma_ms = graph_ms(
                    lambda: cf._launch_tile(xs, tk, d, 0, 1 << 15, prec,
                                            _fma=True), 20)
                print(f"decim routes 64x2^15 outputs d{d} K{kk} {prec}: "
                      f"tensor_ms={tensor_ms:.4f} fma_ms={fma_ms:.4f} (a call "
                      f"takes {cf._route(prec, d, kk, 64, 1 << 15)})",
                      flush=True)
    del xs

    # complex streams at a small shape, against the plain complex FIR
    k, d = 200, 4
    xc = torch.from_numpy((rng.randn(4, 4096 * d + k - 1)
                           + 1j * rng.randn(4, 4096 * d + k - 1)
                           ).astype(np.complex64)).to(dev)
    tr = torch.from_numpy((rng.randn(k) / k).astype(np.float32)).to(dev)
    # (one launch in the complex mode; the library call is conv1d on
    # complex64)
    case("fir_decim_c 4x16k K200 d4", "fir_decim_fwd", "f32",
         lambda: cf.fir_decim_c(xc, tr, d, precision="f32"),
         lambda: fir.fir_filter(xc, tr, d, "f32"),
         flop=2 * k * 2 * 4 * 4096, nbytes=8 * xc.numel() + 4 * k + 8 * 4 * 4096,
         library=conv1d(xc, tr, d), launches_a_call=1)
    k, d = 96, 2
    xc = torch.from_numpy((rng.randn(4, 4096 * d + k - 1)
                           + 1j * rng.randn(4, 4096 * d + k - 1)
                           ).astype(np.complex64)).to(dev)
    tc = torch.from_numpy(((rng.randn(k) + 1j * rng.randn(k)) / k
                           ).astype(np.complex64)).to(dev)
    # (one launch over both tap planes, the route cuda_fir._route names)
    case("fir_decim_cc 4x8k K96 d2",
         "fir_decim_mma_fwd" if cf._route("bf16x3", d, k, 4, 4096,
                                          cplx=cf.CCC) == "decim_mma"
         else "fir_decim_fwd", "bf16x3",
         lambda: cf.fir_decim_cc(xc, tc, d, precision="bf16x3"),
         lambda: fir.fir_filter(xc, tc, d, "bf16x3"),
         flop=2 * k * 4 * 4 * 4096, nbytes=8 * xc.numel() + 8 * k + 8 * 4 * 4096,
         library=conv1d(xc, tc, d), launches_a_call=1)
    del xc

    # the headline workload (bench.py): 16 pipes x 2^20 samples, 16 stages
    # of 256 taps, as an explicit cascade and composed into 4097 taps
    taps = (np.random.RandomState(0).randn(256) * 0.05).astype(np.float32)
    comp = fir.compose_taps_power(taps, 16)
    xb = torch.from_numpy(np.random.RandomState(1).randn(16, 1 << 20)
                          .astype(np.float32)).to(dev)
    t256 = cf._tapsets(taps, dev)[0]
    tcomp = cf._tapsets(comp, dev)
    headline = {"x": xb, "taps": t256, "comp": tcomp, "bank": bank}
    n, kc = 1 << 20, len(comp)
    io_bytes = 4 * 2 * xb.numel()
    for prec in ("f32", "bf16x3", "bf16"):
        headline[prec] = case(
            "fir_cascade 16x2^20 S16 K256",
            "fir_cascade_fwd" if prec == "f32" else "fir_cascade_mma_fwd", prec,
            lambda: cf.fir_cascade(xb, t256, 16, precision=prec),
            lambda: cf.fir_cascade_ref(xb, t256, 16, prec),
            flop=2 * 256 * 16 * xb.numel(), nbytes=io_bytes + 4 * 256, reps=3,
            fma=None if prec == "f32" else
            (lambda: cf._launch_cascade(xb, t256, 16, prec, _fma=True)))
    # the composed filter has zero history: the library call gets the stream
    # behind its K-1 zeros, padded outside the timed call
    xpad = torch.nn.functional.pad(xb, (kc - 1, 0))
    headline["comp f32"] = case(
         "fir_cascade 16x2^20 K4097", "fir_tile_fwd", "f32",
         lambda: cf.fir_cascade(xb, tcomp, 1, precision="f32"),
         lambda: cf.fir_tile_ref(xb, tcomp, 1, kc - 1, n, "f32"),
         flop=2 * kc * xb.numel(), nbytes=io_bytes + 4 * kc, reps=3,
         twin_reps=2, library=conv1d(xpad, tcomp[0], 1), lib_reps=2)
    headline["comp bf16x3"] = case(
        "fir_cascade 16x2^20 K4097", "fir_toeplitz_fwd", "bf16x3",
        lambda: cf.fir_cascade(xb, tcomp, 1, precision="bf16x3"),
        lambda: cf.fir_tile_ref(xb, tcomp, 1, kc - 1, n, "bf16x3"),
        flop=2 * kc * xb.numel(), nbytes=io_bytes + 4 * kc, reps=3,
        twin_reps=2, library=conv1d(xpad, tcomp[0], 1), lib_reps=2,
        fma=lambda: cf._launch_tile(xb, tcomp, 1, kc - 1, n, "bf16x3",
                                    _fma=True))
    xb16 = xb.to(torch.bfloat16)
    headline["x16"] = xb16
    y16 = headline["comp bf16in"] = case(
        "fir_cascade 16x2^20 K4097 bf16in", "fir_toeplitz_fwd", "bf16",
        lambda: cf.fir_cascade(xb16, tcomp, 1, precision="bf16"),
        lambda: cf.fir_tile_ref(xb16, tcomp, 1, kc - 1, n, "bf16"),
        flop=2 * kc * xb.numel(), nbytes=6 * xb.numel() + 4 * kc, reps=3,
        twin_reps=2,
        library=conv1d(xpad.to(torch.bfloat16), tcomp[0], 1), lib_reps=2,
        fma=lambda: cf._launch_tile(xb16, tcomp, 1, kc - 1, n, "bf16",
                                    _fma=True))
    del xpad
    y32 = cf.fir_cascade(xb, tcomp, 1, precision="bf16")
    same = torch.equal(y16, y32)
    print(f"bf16-resident input bit-identical to f32 input at bf16: {same}")
    if not same:
        fail("bf16-resident output differs from the f32-input bf16 output")
    del xb16, y16, y32

    # short filters at decimation 1: the two routes side by side at the
    # filter lengths around cuda_fir._TZ_MIN_TAPS (timed only)
    for kk in (32, 64, 128):
        tk = cf._tapsets(np.random.RandomState(kk).randn(kk) / kk, dev)
        for prec in ("bf16", "bf16x3"):
            tz, fma_ms = in_turns(
                lambda: cf._launch_toeplitz(xb, tk, kk - 1, n, prec),
                lambda: cf._launch_tile(xb, tk, 1, kk - 1, n, prec, _fma=True),
                5, 5)
            print(f"routes 16x2^20 K{kk} {prec}: tensor_ms={tz:.4f} "
                  f"fma_ms={fma_ms:.4f} (K >= {cf._TZ_MIN_TAPS} takes the "
                  f"tensor-core route)", flush=True)

    # bench.py's chain-SNR gate against float64, on 2^15 samples
    xs = np.random.RandomState(7).randn(1, 1 << 15).astype(np.float32)
    r = xs[0].astype(np.float64)
    for _ in range(16):
        r = np.convolve(np.concatenate([np.zeros(255), r]),
                        taps.astype(np.float64), "valid")
    xs_t = torch.from_numpy(xs).to(dev)
    for label, xin, prec in (("bf16x3", xs_t, "bf16x3"),
                             ("bf16-resident bf16", xs_t.to(torch.bfloat16),
                              "bf16")):
        y = cf.fir_cascade(xin, tcomp, 1, precision=prec)[0].cpu().numpy()
        s = snr_db(r, y.astype(np.float64))
        print(f"composed 4097-tap {label}: chain SNR vs float64 = {s:.2f} dB "
              f"(gate {SNR_GATE_DB} dB)")
        if not s >= SNR_GATE_DB:
            fail(f"composed {label} chain SNR {s:.2f} dB < {SNR_GATE_DB} dB")
    return rows, headline


IIR1_BANK = (64, 1 << 18)          # a bank of de-emphasis channels
IIR1_CHUNK = MAIN_CHUNK // AUDIO_DECIM   # phase 4's de-emphasis chunk
IIR1_HELD = 2        # calls at each shape hold_iir1 holds to the plain form


def iir1_tol(k: int, nff: int) -> float:
    """iir1_fwd against its plain form, on max|got - ref| / scale with scale
    the response's bound (the feed-forward taps' sum of magnitudes times
    the input's largest magnitude over 1 - |a|, plus |y0|): each form sums
    K + nff float32 terms in its own order, each rounding by at most 2^-24
    of a partial sum within that bound."""
    return 2 * (k + nff) * 2.0 ** -24


def run_iir1(torch, cf):
    """Phase 3b: iir1_fwd at phase 4's chunk and the benchmark's
    (FmDeemph's IirFilter through dsp.iir_filter, 1 x 8,192 and 1 x
    65,536) and at a bank (64 x 2^18, the same taps, cuda_iir.iir1_fwd):
    one launch a call, the plain form on the CPU (chunks) or on the card
    (bank) within iir1_tol, both timed back to back and replayed from a
    CUDA graph.  Returns the kernels line's row, at phase 4's chunk."""
    from grtpu_torch.blocks.filter import IirFilter
    from grtpu_torch.ops import cuda_iir, dsp
    from grtpu_torch.ops.fir import fir_filter

    fs, tau = QUAD_RATE / AUDIO_DECIM, 75e-6
    kk = math.tan(1.0 / (tau * 2.0 * fs))           # models/fm.py FmDeemph
    blk = IirFilter([kk / (1 + kk)] * 2, [1.0, (1 - kk) / (1 + kk)])
    a = float(blk.fb[1])
    k = dsp._pole_taps(a)
    dev = torch.device("cuda")
    ff = torch.from_numpy(blk.ff).to(dev)
    s0, s1 = dsp.pole_series(a, k, dev)
    rng = np.random.RandomState(21)
    smi = gpu_line()
    row = None
    for label, rows, n in ((f"1x{IIR1_CHUNK}", 1, IIR1_CHUNK),
                           ("1x65536", 1, 65536),
                           (f"{IIR1_BANK[0]}x2^18", *IIR1_BANK)):
        x = torch.from_numpy(rng.randn(rows, n).astype(np.float32)).to(dev)
        hist = torch.from_numpy(rng.randn(rows, 1).astype(np.float32)).to(dev)
        y0 = torch.from_numpy(rng.randn(rows).astype(np.float32)).to(dev)
        if rows == 1:
            x, hist, y0 = x[0], hist[0], y0[:1]

            def run():
                return dsp.iir_filter(x, (hist, y0), ff, blk.fb)[0]
        else:
            def run():
                return cuda_iir.iir1_fwd(x, hist, ff, s0, s1, y0)[0]

        def plain(x=x, hist=hist, y0=y0):
            v = fir_filter(torch.cat([hist, x], dim=-1), ff, 1)
            return dsp.truncated_plain(a, k, v, y0 if rows > 1 else y0[0])

        before = dict(cf.launches)
        got = run()
        launched = {nm: cf.launches[nm] - before[nm] for nm in cf.launches
                    if cf.launches[nm] != before[nm]}
        if launched != {"iir1_fwd": 1}:
            fail(f"iir1 {label}: one call launched {launched}")
        if rows == 1:
            ref = plain(x.cpu(), hist.cpu(), y0.cpu()).to(dev)
            twin = "CPU"
        else:
            ref = plain()
            twin = "card"
        torch.cuda.synchronize()
        scale = (float(ff.abs().sum()) * float(x.abs().max()) / (1 - abs(a))
                 + float(y0.abs().max()))
        abs_err, rel_err = errors(got, ref)
        tol = iir1_tol(k, 2)
        ms = launch_ms(run)
        g_ms = graph_ms(run, 20)
        plain_ms = launch_ms(plain, reps=5, rounds=3)
        g_plain = graph_ms(plain, 5)
        nbytes = 4 * (2 * rows * n + 2 * rows + 2 * k + 2)
        bound_ms, bound_by = bound(2 * (k + 2) * rows * n, nbytes, "f32")
        ok = abs_err <= tol * scale
        print(f"kernel iir1 {label} nff2 K{k} iir1_fwd f32 launches_a_call=1 "
              f"max_abs_err={abs_err:.3e} (tol {tol * scale:.3e}, the plain "
              f"form on the {twin}) max_rel_err={rel_err:.3e} "
              f"kernel_ms={ms:.4f} in_a_graph kernel_ms={g_ms:.4f} "
              f"plain_ms={plain_ms:.4f} in_a_graph plain_ms={g_plain:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}) share_of_bound "
              f"(graph)={bound_ms / g_ms:.3f} {'ok' if ok else 'FAIL'}; "
              f"{smi}", flush=True)
        if not ok:
            fail(f"iir1 {label}: the kernel disagrees with its plain form")
        if n == IIR1_CHUNK:
            row = {"name": "iir1_fwd", "route": "cuda",
                   "source": "grtpu_torch/csrc/iir1.cu",
                   "replaces": "grtpu/ops/dsp.py linear_recurrence_const and "
                               "iir_filter's first-order branch (XLA ops; no "
                               "Pallas kernel)",
                   "launches": None, "max_abs_err": abs_err, "ms": ms,
                   "graph_ms": g_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None}
    return row


def hold_iir1(torch):
    """From here on, every call of cuda_iir.iir1_fwd (which dsp's first-order
    branches call) outside a CUDA-graph capture, up to IIR1_HELD at each
    (shape, dtype, nff, K), is held to its plain form on the CPU: the
    feed-forward sum as dsp.iir_filter's CPU branch makes it, then
    dsp.truncated_plain, within iir1_tol, and the x history bit for bit.
    So each WBFM path is checked at its own shape.  Returns the tally
    {(shape, dtype, nff, K): calls held}."""
    from grtpu_torch.ops import cuda_iir, dsp
    from grtpu_torch.ops.fir import fir_filter

    launch = cuda_iir.iir1_fwd
    held = {}

    def checked(x, x_hist, ff, apow, apow1, y0):
        out = launch(x, x_hist, ff, apow, apow1, y0)
        nff = 1 if ff is None else ff.shape[0]
        key = (tuple(x.shape), str(x.dtype).replace("torch.", ""), nff,
               apow.shape[0])
        if held.get(key, 0) >= IIR1_HELD or x.shape[-1] == 0 \
                or torch.cuda.is_current_stream_capturing():
            return out
        pole = [kk for kk, series in dsp._POLE_SERIES.items()
                if series[0] is apow]
        if not pole:
            fail(f"iir1_fwd at {key}: its series are not dsp.pole_series'")
        a, k = pole[0][0], pole[0][1]
        xc = x.cpu()
        hc = None if x_hist is None else x_hist.cpu().to(xc.dtype)
        y0c = y0.cpu() if isinstance(y0, torch.Tensor) else y0
        if isinstance(y0c, torch.Tensor) and y0c.numel() == 1:
            y0c = y0c.reshape(())
        if ff is None:
            v = xc
        elif nff == 1:
            v = xc * ff.cpu()[0]
        else:
            v = fir_filter(torch.cat([hc, xc], dim=-1), ff.cpu(), 1)
        ref = dsp.truncated_plain(a, k, v, y0c)
        gain = 1.0 if ff is None else float(ff.abs().sum())
        peak = float(xc.abs().max()) if hc is None else max(
            float(xc.abs().max()), float(hc.abs().max()))
        scale = (gain * peak / (1 - abs(a))
                 + float(torch.as_tensor(y0c).abs().max()))
        err = float((out[0].cpu() - ref).abs().max())
        tol = iir1_tol(k, nff) * scale
        if not err <= tol:
            fail(f"iir1_fwd at {key}: max_abs_err {err:.3e} against its plain "
                 f"form on the CPU (tol {tol:.3e})")
        if nff > 1 and not torch.equal(
                out[1].cpu(), torch.cat([hc, xc], dim=-1)[..., -(nff - 1):]):
            fail(f"iir1_fwd at {key}: the x history is not the chunk's last "
                 f"{nff - 1} samples")
        held[key] = held.get(key, 0) + 1
        if held[key] == 1:
            print(f"iir1_fwd at {key} (shape, dtype, nff, K) held to its plain "
                  f"form on the CPU: max_abs_err={err:.3e} (tol {tol:.3e})",
                  flush=True)
        return out

    cuda_iir.iir1_fwd = checked
    return held


MM_CHUNK = 4320       # radiobench's dmr_4fsk48k.stream chunk
MM_ARGS = (float(DMR_SPS), 0.25 * 0.05 ** 2, 0.05, 0.005)   # its loop
MM_REQUEST_STEPS = 1728   # symbols of its 360 ms request: one dependent chain
# The least a step of mm_clock.cu's walk can take: its dependent chain, a
# shared-memory read of the row and window (33 cycles), the dot's 8 fused
# multiply-adds and the update's 11 float32 operations (4 each), floorf
# (19) and the row's index (14), at the latencies a dependent-chain
# microbenchmark reads on an H100 SXM, at its 1,980 MHz.
MM_STEP_FLOOR_NS = (33 + 8 * 4 + 11 * 4 + 19 + 14) / 1.98


def mm_signal(n: int, seed: int) -> np.ndarray:
    """A 4-level stream at DMR_SPS samples a symbol, each symbol's level
    ramped into the next, with noise: the matched filter's output as the
    clock recovery sees it."""
    r = np.random.RandomState(seed)
    nsym = n // DMR_SPS + 2
    sym = r.choice([-1.0, -1 / 3, 1 / 3, 1.0], nsym)
    pos = np.arange(n) / DMR_SPS
    k = pos.astype(int)
    v = (1 - (pos - k)) * sym[k] + (pos - k) * sym[k + 1]
    return (v + 0.05 * r.randn(n)).astype(np.float32)


def run_mm(torch, cf):
    """Phase 3c: mm_fwd at the stream cell's chunk and at one chunk over
    the largest tile: one launch a call, torch.equal to the plain loop on
    the card, timed back to back and replayed, beside the plain loop's
    replayed time and the steps' latency floor.  Returns the kernels
    line's row, at the cell's chunk."""
    from grtpu_torch.digital import loops
    from grtpu_torch.ops import cuda_mm

    dev = torch.device("cuda")
    smi = gpu_line()
    lead = 8 + DMR_SPS + 3 - 1      # ClockRecoveryMMFF's history, less one
    row = None
    for label, n in (("the cell's chunk", MM_CHUNK + lead),
                     ("one chunk over the largest tile",
                      cuda_mm.max_tile(False) + MM_CHUNK + lead)):
        x = torch.from_numpy(mm_signal(n, 26)).to(dev)
        state = loops.mm_init_state(DMR_SPS, 0.5, device=dev)

        def run():
            return loops.clock_recovery_mm_ff(x, state, *MM_ARGS)

        def plain():
            return loops._mm_exact(x, state, *MM_ARGS, clip_err=False)

        before = dict(cf.launches)
        got = run()
        launched = {nm: cf.launches[nm] - before[nm] for nm in cf.launches
                    if cf.launches[nm] != before[nm]}
        if launched != {"mm_fwd": 1}:
            fail(f"mm_fwd at {n} samples: one call launched {launched}")
        want = plain()
        torch.cuda.synchronize()
        pairs = list(zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])))
        if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
            fail(f"mm_fwd at {n} samples is not the plain loop's bit for bit")
        symbols = int(got[1])
        ms = launch_ms(run)
        g_ms = graph_ms(run, 20)
        g_plain = graph_ms(plain, 1) if n == MM_CHUNK + lead else None
        floor_ms = MM_STEP_FLOOR_NS * symbols * 1e-6
        plain_txt = (f"in_a_graph plain_ms={g_plain:.4f}" if g_plain
                     else "plain not timed")
        print(f"kernel mm {label}: {n} samples, {symbols} symbols, "
              f"{len(got[0])} slots, mm_fwd launches_a_call=1, torch.equal "
              f"to the plain loop on the card in ys, n_valid and the state; "
              f"kernel_ms={ms:.4f} in_a_graph kernel_ms={g_ms:.4f} "
              f"({g_ms * 1e6 / symbols:.1f} ns a symbol; "
              f"{g_ms * MM_REQUEST_STEPS / symbols:.4f} ms for the cell's "
              f"{MM_REQUEST_STEPS} steps a request) {plain_txt} "
              f"latency_floor_ms={floor_ms:.4f} ({MM_STEP_FLOOR_NS:.1f} ns a "
              f"step) share_of_floor (graph)={floor_ms / g_ms:.3f}; {smi}",
              flush=True)
        if row is None:
            row = {"name": "mm_fwd", "route": "cuda",
                   "source": "grtpu_torch/csrc/mm_clock.cu",
                   "replaces": "grtpu/digital/loops.py _mm_exact (a lax.scan; "
                               "no Pallas kernel)",
                   "launches": None, "max_abs_err": 0.0, "ms": ms,
                   "graph_ms": g_ms, "plain_ms": g_plain,
                   "bound_ms": floor_ms, "bound_by": "latency",
                   "library_ms": None}
    return row


def wbfm_graph(torch, kernel: bool):
    from grtpu_torch import Graph
    from grtpu_torch.runtime.block import Port
    from grtpu_torch.blocks.analog import FrequencyModulator, QuadratureDemod
    from grtpu_torch.blocks.filter import FirFilter
    from grtpu_torch.models.fm import FmDeemph, WfmRcv
    from grtpu_torch.utils import firdes

    g = Graph()
    pin = g.add_input(Port(torch.float32))
    pout = g.add_output(Port(torch.float32))
    mod = FrequencyModulator(2 * np.pi * 75e3 / QUAD_RATE)
    if kernel:
        # WfmRcv's chain, its audio FIR on the Hopper kernel
        audio_rate = QUAD_RATE / AUDIO_DECIM
        taps = firdes.low_pass(1.0, QUAD_RATE, audio_rate / 2 - 1e3,
                               audio_rate / 10, firdes.Window.HAMMING)
        g.connect(pin, mod,
                  QuadratureDemod(QUAD_RATE / (2 * math.pi * 75e3)),
                  FirFilter(AUDIO_DECIM, taps, "fff", impl="kernel"),
                  FmDeemph(audio_rate, 75e-6), pout)
    else:
        g.connect(pin, mod, WfmRcv(QUAD_RATE, AUDIO_DECIM), pout)
    return g


def run_main_path(torch, cf, headline):
    """Phase 4: the WBFM chain through Graph + StreamExecutor on the card
    (kernel path, then the plain path), the WBFM bank's audio FIR through
    fir_decim and the headline workload through fir_cascade.  Launch counts
    cover exactly these calls."""
    from grtpu_torch import StreamExecutor

    t = np.arange(MAIN_SAMPLES) / QUAD_RATE
    msg = (0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)
    msg_dev = torch.from_numpy(msg).to("cuda")
    executors = {kind: StreamExecutor(wbfm_graph(torch, kind == "kernel"),
                                      chunk_size=MAIN_CHUNK, device="cuda")
                 for kind in ("kernel", "plain")}
    # warm-up on four chunks (cuBLAS handles, first-call allocations) in
    # executors of their own, before the counted run
    for kind in ("kernel", "plain"):
        warm = StreamExecutor(wbfm_graph(torch, kind == "kernel"),
                              chunk_size=MAIN_CHUNK, device="cuda")
        warm.run(msg_dev[:4 * MAIN_CHUNK])
    torch.cuda.synchronize()

    for name in cf.launches:
        cf.launches[name] = 0
    audio, rate = {}, {}
    for kind in ("kernel", "plain"):
        t0 = time.perf_counter()
        y = executors[kind].run(msg_dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        audio[kind] = y.cpu().numpy()
        rate[kind] = MAIN_SAMPLES / dt / 1e6
    x, x16 = headline["x"], headline["x16"]
    bank = headline["bank"]
    yb = {"bank f32": cf.fir_decim(bank["x"], bank["taps"], AUDIO_DECIM,
                                   precision="f32"),
          "comp f32": cf.fir_cascade(x, headline["comp"], 1, precision="f32"),
          "f32": cf.fir_cascade(x, headline["taps"], 16, precision="f32"),
          "bf16x3": cf.fir_cascade(x, headline["taps"], 16,
                                   precision="bf16x3"),
          "comp bf16x3": cf.fir_cascade(x, headline["comp"], 1,
                                        precision="bf16x3"),
          "comp bf16in": cf.fir_cascade(x16, headline["comp"], 1,
                                        precision="bf16")}
    torch.cuda.synchronize()
    counts = dict(cf.launches)

    for kind in ("kernel", "plain"):
        print(f"main path WBFM ({kind}): {MAIN_SAMPLES} samples in "
              f"{MAIN_SAMPLES / rate[kind] / 1e6:.3f} s = "
              f"{rate[kind]:.2f} Msamples/s (chunk {MAIN_CHUNK})")
    print(f"main path launches: {counts}")

    y = audio["kernel"]
    if y.shape != (MAIN_SAMPLES // AUDIO_DECIM,) or not np.isfinite(y).all():
        fail(f"WBFM output shape {y.shape} or non-finite values")
    # recovered-audio SNR against the de-emphasized message
    ref = deemphasized(torch, msg)
    settle = 512
    r, e = align(ref[settle:-settle], y[settle:-settle])
    s = snr_db(r.astype(np.float64), e.astype(np.float64))
    print(f"WBFM recovered-audio SNR: {s:.2f} dB (gate 30 dB)")
    if not s > 30.0:
        fail(f"WBFM audio SNR {s:.2f} dB <= 30 dB")
    diff = np.abs(y - audio["plain"]).max() / np.abs(audio["plain"]).max()
    print(f"WBFM kernel path vs plain path: max_rel_err={diff:.3e} "
          f"(tol {TOL['bf16x3']:g}, the kernel's bf16x3 default)")
    if not diff <= TOL["bf16x3"]:
        fail("kernel WBFM chain disagrees with the plain chain")
    for key, got in yb.items():
        want = bank["f32"] if key == "bank f32" else headline[key]
        if not torch.equal(got, want):
            fail(f"headline workload output ({key}) differs from the checked "
                 f"output of phase 3")
    for name in cf.FIR_KERNELS:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")

    # the same chain under run(device_loop=True): replayed from CUDA graphs,
    # the kernels launched once a chunk, inside the graph
    nchunks = MAIN_SAMPLES // MAIN_CHUNK
    for kind in ("kernel", "plain"):
        _, rates, _, loop_counts = two_modes(
            torch, f"main path WBFM ({kind})",
            lambda: StreamExecutor(wbfm_graph(torch, kind == "kernel"),
                                   chunk_size=MAIN_CHUNK, device="cuda"),
            (msg_dev,), MAIN_SAMPLES, cf=cf)
        rate[f"{kind} device_loop"] = rates["device_loop"]
        # the audio FIR on the kernel path, the de-emphasis on both
        want = {"fir_decim_mma_fwd": nchunks} if kind == "kernel" else {}
        want["iir1_fwd"] = nchunks
        for run in loop_counts:
            if {k: v for k, v in run.items() if v} != want:
                fail(f"WBFM ({kind}) under device_loop launched {run}; "
                     f"expected {want} and nothing else")
    return counts, rate


def dmr_frames(rng, n_dibits, idle=48):
    """Back-to-back bs_data bursts of distinct random payloads between idle
    dibits (DmrTransmitter's framing); returns (dibits, payloads)."""
    from grtpu_torch.models import dmr

    nb = (n_dibits - 2 * idle) // (dmr.BURST_BITS // 2)
    payloads = rng.randint(0, 2, (nb, 2 * dmr.PAYLOAD_HALF_BITS)).astype(np.uint8)
    parts = [rng.randint(0, 4, idle)]
    parts += [dmr.bits_to_dibits(dmr.make_burst(p)) for p in payloads]
    parts.append(rng.randint(0, 4, n_dibits - idle - nb * dmr.BURST_BITS // 2))
    return np.concatenate(parts).astype(np.uint8), payloads


def dmr_channel(torch, iq, cfo_hz, gen):
    """A CFO of cfo_hz and 15 dB of complex AWGN (seeded generator on the
    card) on a constant-envelope stream."""
    n = torch.arange(iq.shape[-1], dtype=torch.float64, device=iq.device)
    rot = torch.exp(1j * (2 * math.pi * cfo_hz / DMR_FS) * n).to(torch.complex64)
    p = (iq.abs() ** 2).mean()
    sigma = torch.sqrt(p / 10 ** (DMR_SNR_DB / 10) / 2)
    noise = torch.complex(
        torch.randn(iq.shape, generator=gen, device=iq.device),
        torch.randn(iq.shape, generator=gen, device=iq.device))
    return iq * rot + sigma * noise


def best_ser(sent, got, settle, max_shift=64):
    """Symbol error rate minimized over the alignment shift, the first
    ``settle`` symbols discarded (tests/test_digital.py's _best_ber)."""
    best = 1.0
    for s in range(max_shift):
        n = min(len(got) - s, len(sent)) - 32
        if n > settle:
            best = min(best, float((got[s + settle: s + n]
                                    != sent[settle:n]).mean()))
    return best


def run_dmr_bank(torch):
    """Phase 5a: the 128-channel burst bank on the card."""
    from grtpu_torch.digital.modems import Fsk4Modem
    from grtpu_torch.models import dmr

    modem = Fsk4Modem(samples_per_symbol=DMR_SPS, device="cuda")
    rng = np.random.RandomState(3)
    gen = torch.Generator(device="cuda").manual_seed(3)
    cfos = rng.uniform(-DMR_CFO_HZ, DMR_CFO_HZ, DMR_CHANNELS)
    n_dibits = -(-DMR_SAMPLES // DMR_SPS)
    x = torch.empty((DMR_CHANNELS, DMR_SAMPLES), dtype=torch.complex64,
                    device="cuda")
    sent = []
    t0 = time.perf_counter()
    for c in range(DMR_CHANNELS):
        dibits, payloads = dmr_frames(rng, n_dibits)
        iq = modem.modulate(dibits)[:DMR_SAMPLES]
        x[c] = dmr_channel(torch, iq, cfos[c], gen)
        sent.append(payloads)
    torch.cuda.synchronize()
    print(f"DMR bank: {DMR_CHANNELS} ch x {DMR_SAMPLES} samples made on the "
          f"card in {time.perf_counter() - t0:.2f} s "
          f"({len(sent[0])} bursts per channel, CFO within "
          f"+-{DMR_CFO_HZ:g} Hz, {DMR_SNR_DB:g} dB)", flush=True)

    dibits = modem.demodulate_burst_bank(x)
    levels = modem._burst_bank_fn(x)
    torch.cuda.synchronize()
    ref = Fsk4Modem(samples_per_symbol=DMR_SPS)._burst_bank_fn(x.cpu())
    if levels.shape != ref.shape or not torch.isfinite(levels).all():
        fail(f"DMR bank levels shape {tuple(levels.shape)} vs "
             f"{tuple(ref.shape)} or non-finite")
    lvl_err = (levels.cpu() - ref).abs().max().item()
    print(f"DMR bank levels, card vs CPU: max_abs_err={lvl_err:.3e} "
          f"(tol {DMR_LEVEL_TOL:g})", flush=True)
    if not lvl_err <= DMR_LEVEL_TOL:
        fail("DMR bank levels on the card disagree with the CPU run")

    worst, n_bursts, n_bits, n_err = 0.0, 0, 0, 0
    for c in range(DMR_CHANNELS):
        found = [dmr.extract_payload(dibits[c], s)
                 for s in dmr.find_bursts(dibits[c], "bs_data", 4)]
        found = np.array([p for p in found if p is not None], np.uint8)
        if found.size == 0:
            fail(f"DMR bank channel {c}: no burst found")
        ber = (sent[c][:, None, :] != found[None, :, :]).mean(-1).min(1)
        worst = max(worst, float(ber.max()))
        n_bursts += len(ber)
        n_bits += ber.size * sent[c].shape[1]
        n_err += int(round((ber * sent[c].shape[1]).sum()))
    print(f"DMR bank: {n_bursts} bursts sent, every one recovered; payload "
          f"BER {n_err / n_bits:.2e} overall, worst burst {worst:.4f} "
          f"(gate {DMR_GATE})", flush=True)
    if not worst < DMR_GATE:
        fail(f"DMR bank: a burst came back with payload BER {worst:.4f}")

    ms = median_ms(lambda: modem._burst_bank_fn(x))
    rate = DMR_CHANNELS * DMR_SAMPLES / ms / 1e3
    print(f"DMR bank {DMR_CHANNELS} ch x {DMR_SAMPLES}: {ms:.3f} ms per call (median of "
          f"5, CUDA events) = {rate:.2f} Msamples/s aggregate", flush=True)
    return rate


def dmr_stream_graph(torch, modem):
    from grtpu_torch import Graph
    from grtpu_torch.runtime.block import Port
    from grtpu_torch.blocks.analog import QuadratureDemod
    from grtpu_torch.blocks.filter import FirFilter
    from grtpu_torch.digital.blocks import ClockRecoveryMMFF, FourLevelSlicer

    g = Graph()
    pin = g.add_input(Port(torch.complex64))
    pout = g.add_output(Port(torch.uint8))
    g.connect(pin, QuadratureDemod(1.0 / modem.sensitivity),
              FirFilter(1, modem.rx_taps / DMR_SPS, "fff", impl="mxu"),
              ClockRecoveryMMFF(omega=DMR_SPS, gain_omega=0.25 * 0.05 ** 2,
                                mu=0.5, gain_mu=0.05,
                                omega_relative_limit=0.005),
              FourLevelSlicer(scale=3.0), pout)
    return g


def run_dmr_stream(torch):
    """Phase 5b: a continuous DMR stream through the variable-rate executor
    and through the chunked closed-loop modem."""
    from grtpu_torch import StreamExecutor
    from grtpu_torch.digital.modems import Fsk4Modem

    modem = Fsk4Modem(samples_per_symbol=DMR_SPS, device="cuda")
    rng = np.random.RandomState(4)
    gen = torch.Generator(device="cuda").manual_seed(4)
    dibits, _ = dmr_frames(rng, DMR_STREAM // DMR_SPS)
    x = dmr_channel(torch, modem.modulate(dibits), 0.0, gen)

    StreamExecutor(dmr_stream_graph(torch, modem), chunk_size=DMR_CHUNK,
                   device="cuda").run(x[:DMR_CHUNK])
    torch.cuda.synchronize()
    ex = StreamExecutor(dmr_stream_graph(torch, modem), chunk_size=DMR_CHUNK,
                        device="cuda")
    t0 = time.perf_counter()
    got = ex.run(x).cpu().numpy()
    dt = time.perf_counter() - t0
    ser = best_ser(dibits, got, DMR_SETTLE)
    vr_rate = len(got) / dt
    print(f"DMR stream, variable-rate executor: {DMR_STREAM} samples -> "
          f"{len(got)} dibits in {dt:.3f} s = {vr_rate:.1f} symbols/s "
          f"(chunk {DMR_CHUNK}); SER {ser:.4f} (gate {DMR_GATE})", flush=True)
    if got.dtype != np.uint8 or len(got) < 0.9 * len(dibits):
        fail(f"DMR stream: {len(got)} dibits of dtype {got.dtype}")
    if not ser < DMR_GATE:
        fail(f"DMR stream SER {ser:.4f} >= {DMR_GATE}")
    _, rates, _, _ = two_modes(
        torch, "DMR stream, variable-rate executor",
        lambda: StreamExecutor(dmr_stream_graph(torch, modem),
                               chunk_size=DMR_CHUNK, device="cuda"),
        (x,), len(got), unit="symbols/s", per=1.0)

    chunked = Fsk4Modem(samples_per_symbol=DMR_SPS, chunked=True,
                        device="cuda")
    chunked.demodulate(x[:DMR_CHUNK])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = chunked.demodulate(x)
    dt = time.perf_counter() - t0
    ser = best_ser(dibits, got, DMR_SETTLE)
    ck_rate = len(got) / dt
    print(f"DMR stream, Fsk4Modem(chunked=True).demodulate: {len(got)} "
          f"dibits in {dt:.3f} s = {ck_rate:.1f} symbols/s; SER {ser:.4f} "
          f"(gate {DMR_GATE}); chunked / executor = {ck_rate / vr_rate:.1f}x",
          flush=True)
    if not ser < DMR_GATE:
        fail(f"DMR chunked demod SER {ser:.4f} >= {DMR_GATE}")
    return vr_rate, ck_rate, rates["device_loop"]


# ------------------------------------------------- phases 6 and 7 (configs 1, 2)
CAPTURE_FS = 2.048e6
CAPTURE_SAMPLES = 1 << 23
CAPTURE_CHUNK = 524288
TUNE_HZ = 400e3
TUNER_DECIM = 8
CELL_CHUNK = 4194304         # radiobench's wbfm_rtl2048.file runs at this chunk
PHASE_HZ = 400.1e3           # a centre at which a chunk leaves the phase off 0
NBFM_SAMPLES = 1 << 20
STEREO_SAMPLES = 1 << 21
PFB_CHANNELS = 64            # benchmarks/channelizer_bench.py:37
PFB_SAMPLES = 1 << 20
ARB_ROWS = 64                # benchmarks/resampler_bench.py:38-39
ARB_CASES = (("3/2", (3, 2), 1 << 17), ("160/147", (160, 147), 147 * 900))
PFB_STREAM = 1 << 22
SYNC_SAMPLES = 12000
SYNC_CHUNK = 4000
LOOP_SAMPLES = 8192
LOOP_CHUNK = 2048


def chain_graph(torch, chain, in_dtype, out_dtypes=None):
    """input pad -> chain -> one output pad per output port of the last
    block (or per dtype in ``out_dtypes``, for a hierarchical last block)."""
    from grtpu_torch import Graph
    from grtpu_torch.runtime.block import Port

    g = Graph()
    pin = g.add_input(Port(in_dtype))
    ports = ([Port(dt) for dt in out_dtypes] if out_dtypes
             else list(chain[-1].out_ports))
    if len(ports) == 1:
        g.connect(pin, *chain, g.add_output(ports[0]))
    else:
        g.connect(pin, *chain)
        for i, port in enumerate(ports):
            g.connect((chain[-1], i), g.add_output(port))
    return g


def bit_accuracy(decisions, bits, settle=200, max_shift=32):
    """Share of +-1 decisions equal to the sent bits, best over the
    alignment shift and the sign (a BPSK loop locks at either)."""
    best = 0.0
    for off in range(max_shift):
        m = min(len(decisions) - off, len(bits)) - 2 * settle
        if m <= 0:
            break
        d = decisions[off + settle: off + settle + m]
        b = bits[settle: settle + m]
        best = max(best, float((d == b).mean()), float((d == -b).mean()))
    return best


def wideband_capture(seed=6, strong_station=True, noise=0.01,
                     n=CAPTURE_SAMPLES):
    """2^23 complex64 samples at 2.048 MS/s: the wanted station (1 kHz tone,
    75 kHz deviation) at +400 kHz, a stronger one (2.5 kHz tone) at -300 kHz
    (left out with ``strong_station=False``), and noise of ``noise`` a
    dimension.  Returns (capture, message at the capture rate)."""
    t = np.arange(n) / CAPTURE_FS
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    k = 2 * np.pi * 75e3 / CAPTURE_FS
    x = np.exp(1j * (2 * np.pi * TUNE_HZ * t + np.cumsum(k * msg)))
    if strong_station:
        other = 0.5 * np.sin(2 * np.pi * 2500.0 * t)
        x += 3.0 * np.exp(1j * (2 * np.pi * -300e3 * t + np.cumsum(k * other)))
    rng = np.random.RandomState(seed)
    x = x.astype(np.complex64)
    x.real += noise * rng.standard_normal(n).astype(np.float32)
    x.imag += noise * rng.standard_normal(n).astype(np.float32)
    return x, msg.astype(np.float32)


def discriminator_message(msg, decim=TUNER_DECIM):
    """The message as the quadrature discriminator after a decimation by
    ``decim`` measures it: the phase step over ``decim`` capture samples,
    i.e. the mean of the message over the window ending at each sample
    (centred (decim - 1) / 2 samples earlier than the sample itself)."""
    return np.convolve(msg, np.ones(decim) / decim)[: len(msg)].astype(
        np.float32)


def run_tuner_wbfm(torch, cf):
    """Phase 6a: config #1 in full, tuner -> WBFM, on the card."""
    from grtpu_torch import StreamExecutor
    from grtpu_torch.blocks.filter import FreqXlatingFirFilter
    from grtpu_torch.models.fm import FmDeemph, WfmRcv
    from grtpu_torch.utils import firdes

    taps = firdes.low_pass(1.0, CAPTURE_FS, 100e3, 50e3)

    def executor(impl, chunk=CAPTURE_CHUNK, tuner_taps=taps):
        tuner = FreqXlatingFirFilter(TUNER_DECIM, tuner_taps, TUNE_HZ,
                                     CAPTURE_FS)
        g = chain_graph(torch, [tuner, WfmRcv(QUAD_RATE, AUDIO_DECIM, impl=impl)],
                        torch.complex64, [torch.float32])
        return StreamExecutor(g, chunk_size=chunk, device="cuda"), tuner

    t0 = time.perf_counter()
    x, msg = wideband_capture()
    x_dev = torch.from_numpy(x).to("cuda")
    print(f"capture: {CAPTURE_SAMPLES} samples at {CAPTURE_FS / 1e6:g} MS/s "
          f"made in {time.perf_counter() - t0:.1f} s ({len(taps)}-tap tuner, "
          f"decimation {TUNER_DECIM})", flush=True)
    for impl in ("kernel", "mxu"):     # warm-up in executors of their own
        executor(impl)[0].run(x_dev[:2 * CAPTURE_CHUNK])
    torch.cuda.synchronize()

    for name in cf.launches:
        cf.launches[name] = 0
    audio, rate = {}, {}
    for impl in ("kernel", "mxu"):
        ex = executor(impl)[0]
        t0 = time.perf_counter()
        y = ex.run(x_dev)
        torch.cuda.synchronize()
        rate[impl] = CAPTURE_SAMPLES / (time.perf_counter() - t0) / 1e6
        audio[impl] = y.cpu().numpy()
    counts = dict(cf.launches)
    for impl in ("kernel", "mxu"):
        print(f"tuner -> WBFM ({impl}): {CAPTURE_SAMPLES} input samples at "
              f"{rate[impl]:.2f} Msamples/s of input (chunk {CAPTURE_CHUNK})")
    print(f"tuner path launches: {counts}", flush=True)
    nchunks = CAPTURE_SAMPLES // CAPTURE_CHUNK
    if counts["fir_decim_mma_fwd"] < nchunks:
        fail(f"tuner path launched fir_decim_mma_fwd {counts['fir_decim_mma_fwd']} "
             f"times, expected {nchunks}")

    total_decim = TUNER_DECIM * AUDIO_DECIM
    y = audio["kernel"]
    if y.shape != (CAPTURE_SAMPLES // total_decim,) or not np.isfinite(y).all():
        fail(f"tuner -> WBFM output shape {y.shape} or non-finite values")
    g = chain_graph(torch, [FmDeemph(QUAD_RATE / AUDIO_DECIM, 75e-6)],
                    torch.float32, [torch.float32])
    # the tuner's group delay, (len(taps) - 1) / 2 capture samples, is not a
    # whole audio sample: sample the reference message on the delayed grid,
    # so that the alignment below is left a whole number of audio samples
    first = -((len(taps) - 1) // 2) % total_decim
    ref = StreamExecutor(g, chunk_size=8192, device="cuda").run(
        msg[first::total_decim]).cpu().numpy()

    def audio_snr(y, reference=ref):
        settle = 512
        r, e = align(reference[settle:-settle], y[settle:-settle])
        return snr_db(r.astype(np.float64), e.astype(np.float64))

    s = audio_snr(y)
    print(f"tuner -> WBFM recovered-audio SNR: {s:.2f} dB (gate 30 dB)")
    if not s > 30.0:
        fail(f"tuner -> WBFM audio SNR {s:.2f} dB <= 30 dB")
    diff = np.abs(y - audio["mxu"]).max() / np.abs(audio["mxu"]).max()
    print(f"tuner -> WBFM kernel path vs mxu path: max_rel_err={diff:.3e} "
          f"(tol {TOL['bf16x3']:g})")
    if not diff <= TOL["bf16x3"]:
        fail("tuner -> WBFM kernel path disagrees with the mxu path")

    # both modes at this chunk (mxu and kernel) and, on the kernel path, at
    # the main path's chunk 65,536: the audio SNR at each chunk separates
    # the float32 rotator's long ramps from the filters' own distortion
    snrs = {CAPTURE_CHUNK: s}
    for impl, chunk in (("mxu", CAPTURE_CHUNK), ("kernel", CAPTURE_CHUNK),
                        ("kernel", 65536)):
        outs, rates, _, loop_counts = two_modes(
            torch, f"tuner -> WBFM ({impl}, chunk {chunk})",
            lambda: executor(impl, chunk)[0], (x_dev,), CAPTURE_SAMPLES,
            cf=cf)
        rate[f"{impl} {chunk} device_loop"] = rates["device_loop"]
        # the audio FIR on the kernel path, the de-emphasis on both
        want = {"fir_decim_mma_fwd": CAPTURE_SAMPLES // chunk} \
            if impl == "kernel" else {}
        want["iir1_fwd"] = CAPTURE_SAMPLES // chunk
        for run in loop_counts:
            if {k: v for k, v in run.items() if v} != want:
                fail(f"tuner -> WBFM ({impl}, chunk {chunk}) under "
                     f"device_loop launched {run}; expected {want} and "
                     f"nothing else")
        if impl == "kernel" and chunk != CAPTURE_CHUNK:
            snrs[chunk] = audio_snr(outs[0].cpu().numpy())
    print(f"tuner -> WBFM recovered-audio SNR by chunk: "
          + ", ".join(f"{c}: {v:.2f} dB" for c, v in snrs.items()), flush=True)
    if not min(snrs.values()) > 30.0:
        fail(f"tuner -> WBFM audio SNR {snrs} has a chunk at or below 30 dB")

    # what sets the 39 dB: the same chain on the same capture without the
    # 3x stronger station at -300 kHz (its alias after decimation by 8)
    lone, _ = wideband_capture(strong_station=False)
    y = executor("kernel")[0].run(torch.from_numpy(lone).to("cuda"))
    s_lone = audio_snr(y.cpu().numpy())
    print(f"tuner -> WBFM recovered-audio SNR, chunk {CAPTURE_CHUNK}: "
          f"{s:.2f} dB with the -300 kHz station, {s_lone:.2f} dB without it",
          flush=True)
    if not s_lone > 30.0:
        fail(f"tuner -> WBFM audio SNR without the strong station {s_lone:.2f} dB")

    # diagnostics of the 39 dB (printed, not gated): a wider tuner passband
    # (cutoff 150 kHz), the capture without its noise, and the reference
    # sampled where the discriminator measures after the tuner's decimation
    # (the phase step over 8 capture samples: 3.5 samples earlier than the
    # capture grid the reference above is taken on)
    wide = firdes.low_pass(1.0, CAPTURE_FS, 150e3, 50e3)
    y_wide = executor("kernel", tuner_taps=wide)[0].run(x_dev).cpu().numpy()
    first_w = -((len(wide) - 1) // 2) % total_decim
    ref_w = StreamExecutor(g, chunk_size=8192, device="cuda").run(
        msg[first_w::total_decim]).cpu().numpy()
    quiet, _ = wideband_capture(noise=0.0)
    y_quiet = executor("kernel")[0].run(
        torch.from_numpy(quiet).to("cuda")).cpu().numpy()
    ref_d = StreamExecutor(g, chunk_size=8192, device="cuda").run(
        discriminator_message(msg)[first::total_decim]).cpu().numpy()
    print(f"tuner -> WBFM SNR diagnostics, chunk {CAPTURE_CHUNK}: "
          f"{len(wide)}-tap tuner with cutoff 150 kHz "
          f"{audio_snr(y_wide, ref_w):.2f} dB; capture without noise "
          f"{audio_snr(y_quiet):.2f} dB; reference taken as the discriminator "
          f"measures it (mean over 8 capture samples) "
          f"{audio_snr(audio['kernel'], ref_d):.2f} "
          f"dB, without noise {audio_snr(y_quiet, ref_d):.2f} dB", flush=True)
    # phase 13 runs the same chain from a flowgraph file on the same capture
    return rate, counts, {"capture": x, "taps": taps, "audio": audio,
                          "snr": audio_snr}


def run_tuner_kernel(torch, cf, capture):
    """Phase 6a, the tuner on the hand kernel at the benchmark cell's shape
    (radiobench's wbfm_rtl2048.file): FreqXlatingFirFilter(8, the 99-tap
    low-pass, TUNE_HZ, impl="kernel") -> WfmRcv(impl="kernel"), chunk
    CELL_CHUNK, two runs eager and two under device_loop.  Gates: each
    device_loop run launches, a chunk, fir_decim_mma_fwd twice (the tuner's
    ccc launch and the audio FIR), fir_decim_cc once and iir1_fwd once, and
    nothing else (counts zeroed just before the run, read just after); its
    output torch.equal to the eager run's; the first within bf16x3's
    tolerance of the same chain with the tuner on impl="mxu".  Then the
    rotator's carried phase, at PHASE_HZ, where a chunk does not bring the
    phase back to 0 (at TUNE_HZ every chunk is a whole number of cycles):
    after each of two device_loop runs (the capture, then a replay) within
    1e-6 rad of the exact closed form -2 pi ((f_c N) mod f_s) / f_s, worked
    out in rationals."""
    from grtpu_torch import StreamExecutor
    from grtpu_torch.blocks.filter import FreqXlatingFirFilter
    from grtpu_torch.models.fm import WfmRcv
    from grtpu_torch.utils import firdes

    taps = firdes.low_pass(1.0, CAPTURE_FS, 100e3, 50e3)

    def executor(tuner_impl, centre=TUNE_HZ):
        tuner = FreqXlatingFirFilter(TUNER_DECIM, taps, centre, CAPTURE_FS,
                                     impl=tuner_impl)
        g = chain_graph(torch, [tuner, WfmRcv(QUAD_RATE, AUDIO_DECIM,
                                              impl="kernel")],
                        torch.complex64, [torch.float32])
        return StreamExecutor(g, chunk_size=CELL_CHUNK, device="cuda"), tuner

    x_dev = torch.from_numpy(capture).to("cuda")
    nchunks = CAPTURE_SAMPLES // CELL_CHUNK
    label = f"tuner (kernel) -> WBFM, chunk {CELL_CHUNK}"
    outs, _, _, loop_counts = two_modes(
        torch, label, lambda: executor("kernel")[0], (x_dev,), CAPTURE_SAMPLES,
        cf=cf)
    want = {"fir_decim_mma_fwd": 2 * nchunks, "fir_decim_cc": nchunks,
            "iir1_fwd": nchunks}
    for run in loop_counts:
        if {k: v for k, v in run.items() if v} != want:
            fail(f"{label} under device_loop launched {run}; expected {want} "
                 f"and nothing else")
    y = outs[0].cpu().numpy()
    ref = executor("mxu")[0].run(x_dev).cpu().numpy()
    if y.shape != ref.shape or not np.isfinite(y).all():
        fail(f"{label}: output shape {y.shape} or non-finite values")
    diff = np.abs(y - ref).max() / np.abs(ref).max()
    print(f"{label} vs the tuner on impl=\"mxu\": max_rel_err={diff:.3e} "
          f"(tol {TOL['bf16x3']:g})", flush=True)
    if not diff <= TOL["bf16x3"]:
        fail(f"{label} disagrees with the tuner on impl=\"mxu\"")

    ex, tuner = executor("kernel", PHASE_HZ)
    for run in (1, 2):
        ex.run(x_dev, device_loop=True)
        got = float(ex.state["blocks"][str(tuner.uid)])
        n = run * CAPTURE_SAMPLES
        turns = (-Fraction(PHASE_HZ) / Fraction(CAPTURE_FS) * n) % 1
        exact = 2 * math.pi * float(turns)
        off = abs(math.remainder(got - exact, 2 * math.pi))
        print(f"rotator phase at {PHASE_HZ / 1e3:g} kHz after {run * nchunks} "
              f"chunks of {CELL_CHUNK} (device_loop): {got:.9f} rad; exact "
              f"closed form {exact:.9f} (off by {off:.2e}, gate 1e-6)",
              flush=True)
        if turns == 0 or not off <= 1e-6:
            fail("the rotator's carried phase left the exact closed form")


def run_channel_select(torch, cf, capture, decim=TUNER_DECIM):
    """Phase 6c: config #1's capture through the channel-select filter of a
    narrowband receiver, FirFilter(decim, the tuner's 99-tap low-pass
    turned to the station at TUNE_HZ, "ccc", impl="kernel") (what the GRC
    registry's gr_fir_filter_ccc builds), decimating by 8 and at decimation
    1 (a complex matched filter at full rate), at chunk 524,288 in both run
    modes, two runs each (an executor carries its history from one run into
    the next, so runs are compared by their index).  Gates: one launch a
    chunk of a FIR kernel, counted under fir_decim_cc too, and nothing else
    (counts zeroed just before each
    run and read just after it), each device_loop run torch.equal to the
    eager run of its index, the first run within bf16x3's tolerance of
    impl="mxu"'s."""
    from grtpu_torch import StreamExecutor
    from grtpu_torch.blocks.filter import FirFilter
    from grtpu_torch.ops.fir import rotate_taps
    from grtpu_torch.utils import firdes

    taps = rotate_taps(firdes.low_pass(1.0, CAPTURE_FS, 100e3, 50e3),
                       TUNE_HZ, CAPTURE_FS)
    x_dev = torch.from_numpy(capture).to("cuda")
    nchunks = CAPTURE_SAMPLES // CAPTURE_CHUNK

    def executor(impl):
        g = chain_graph(torch, [FirFilter(decim, taps, "ccc", impl=impl)],
                        torch.complex64)
        return StreamExecutor(g, chunk_size=CAPTURE_CHUNK, device="cuda")

    mxu = executor("mxu").run(x_dev)
    outs, rates, runs = {}, {}, []
    for mode in ("eager", "device_loop"):
        ex = executor("kernel")
        outs[mode] = []
        for _ in range(2):
            for name in cf.launches:
                cf.launches[name] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = ex.run(x_dev, device_loop=mode == "device_loop")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = {n: v for n, v in cf.launches.items() if v}
            runs.append((mode, counts))
            kernel = sum(counts.get(n, 0) for n in ("fir_decim_fwd",
                                                     "fir_decim_mma_fwd",
                                                     "fir_tile_fwd"))
            if (kernel != nchunks or counts.get("fir_decim_cc") != nchunks
                    or sum(counts.values()) != 2 * nchunks):
                fail(f"channel select ccc d{decim} ({mode}) launched "
                     f"{counts}; expected one FIR launch a chunk "
                     f"({nchunks})")
            outs[mode].append(y)
        rates[mode] = CAPTURE_SAMPLES / secs / 1e6
    same = all(torch.equal(a, b)
               for a, b in zip(outs["eager"], outs["device_loop"]))
    y = outs["eager"][0]
    _, err = errors(y, mxu)
    print(f"channel select ccc FirFilter({decim}, {len(taps)} taps turned to "
          f"{TUNE_HZ / 1e3:g} kHz, impl=kernel), {CAPTURE_SAMPLES} input "
          f"samples, chunk {CAPTURE_CHUNK}: eager {rates['eager']:.2f}, "
          f"device_loop {rates['device_loop']:.2f} Msamples/s of input "
          f"(second run of each); launches a run {runs}; output "
          f"{tuple(y.shape)} {y.dtype}; device_loop torch.equal to eager, "
          f"run by run: {same}; kernel vs mxu (first runs) "
          f"max_rel_err={err:.3e} "
          f"(tol {TOL['bf16x3']:g})", flush=True)
    if not same:
        fail(f"channel select ccc d{decim}: the device_loop output differs "
             f"from eager")
    if (y.shape != (CAPTURE_SAMPLES // decim,)
            or not torch.isfinite(torch.view_as_real(y)).all()):
        fail(f"channel select ccc d{decim}: output {tuple(y.shape)} or "
             f"non-finite")
    if not err <= TOL["bf16x3"]:
        fail(f"channel select ccc d{decim}: the kernel path disagrees with "
             f"mxu")


def run_fm_family(torch):
    """Phase 6b: the NBFM loopback and the stereo receiver on the card."""
    from grtpu_torch import StreamExecutor
    from grtpu_torch.models.fm import NbfmRx, NbfmTx, WfmRcvPll

    n = NBFM_SAMPLES
    msg = (0.5 * np.sin(2 * np.pi * 1000.0 * np.arange(n) / 16e3)
           ).astype(np.float32)
    outs, rates, _, _ = two_modes(
        torch, "NbfmTx -> NbfmRx",
        lambda: StreamExecutor(chain_graph(
            torch, [NbfmTx(16e3, 64e3), NbfmRx(16e3, 64e3)], torch.float32,
            [torch.float32]), chunk_size=65536, device="cuda"),
        (torch.from_numpy(msg).to("cuda"),), n)
    audio = outs[0].cpu().numpy()
    seg = audio[2048:2048 + 8192]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    peak = np.argmax(spec) * 16e3 / len(seg)
    inband = spec[np.arange(len(spec)) * 16e3 / len(seg) < 3000].sum() / spec.sum()
    print(f"NbfmTx -> NbfmRx: {n} audio samples at {rates['eager']:.2f} "
          f"Msamples/s; peak {peak:.1f} Hz (1000 +- 10), in-band share "
          f"{inband:.4f} (gate 0.95)", flush=True)
    if audio.shape != (n,) or abs(peak - 1000) >= 10 or not inband > 0.95:
        fail("NBFM loopback did not return the tone")

    n = STEREO_SAMPLES
    t = np.arange(n) / QUAD_RATE
    left = 0.4 * np.sin(2 * np.pi * 700 * t)
    right = 0.4 * np.sin(2 * np.pi * 2200 * t)
    composite = ((left + right) / 2 + 0.1 * np.sin(2 * np.pi * 19000 * t)
                 + (left - right) * np.sin(2 * np.pi * 38000 * t) / 2)
    iq = np.exp(1j * np.cumsum(2 * np.pi * 75e3 / QUAD_RATE * composite)
                ).astype(np.complex64)
    outs, rates, _, _ = two_modes(
        torch, "WfmRcvPll",
        lambda: StreamExecutor(chain_graph(
            torch, [WfmRcvPll(QUAD_RATE, AUDIO_DECIM)], torch.complex64,
            [torch.float32, torch.float32]), chunk_size=65536, device="cuda"),
        (torch.from_numpy(iq).to("cuda"),), n)
    L, R = (v.cpu().numpy() for v in outs[0])

    def band_power(sig, f):
        spec = np.abs(np.fft.rfft(sig * np.hanning(len(sig)))) ** 2
        freqs = np.fft.rfftfreq(len(sig), AUDIO_DECIM / QUAD_RATE)
        return spec[(freqs > f - 100) & (freqs < f + 100)].sum()

    sep_l = band_power(L[2000:], 700) / band_power(L[2000:], 2200)
    sep_r = band_power(R[2000:], 2200) / band_power(R[2000:], 700)
    print(f"WfmRcvPll: {n} samples at {rates['eager']:.2f} Msamples/s; left "
          f"700/2200 Hz power {sep_l:.1f}x, right 2200/700 Hz {sep_r:.1f}x "
          f"(gate 4x each)", flush=True)
    if L.shape != (n // AUDIO_DECIM,) or not (sep_l > 4 and sep_r > 4):
        fail("WfmRcvPll did not separate left from right")


def run_channelizer(torch):
    """Phase 7a: channelize at the benchmark's shape, every mode."""
    from grtpu_torch.ops import pfb

    N = PFB_CHANNELS
    proto = pfb.design_channelizer_taps(N, 12)
    kp = -(-len(proto) // N)
    hist = kp * N
    rng = np.random.RandomState(7)
    x = (rng.standard_normal(PFB_SAMPLES + hist)
         + 1j * rng.standard_normal(PFB_SAMPLES + hist)).astype(np.complex64)
    x_dev = torch.from_numpy(x).to("cuda")

    c, delta = 37, 0.012
    tone = np.exp(2j * np.pi * (c / N + delta / N)
                  * np.arange(PFB_SAMPLES + hist)).astype(np.complex64)
    y = pfb.channelize(torch.from_numpy(tone).to("cuda"), proto, N)
    powers = (y[kp * 2:].abs() ** 2).mean(dim=0).cpu().numpy()
    share = powers[c] / powers.sum()
    print(f"channelize {N} ch, {len(proto)} taps: a tone in channel {c} comes "
          f"out in channel {int(np.argmax(powers))} with {share:.4f} of the "
          f"power (gate 0.95)", flush=True)
    if int(np.argmax(powers)) != c or not share > 0.95:
        fail("channelize routed the tone to the wrong channel")

    outs, rates = {}, {}
    for os_, precision in ((1, "f32"), (1, "bf16x3"), (1, "bf16"),
                           (2, "f32"), (2, "bf16")):
        key = f"os{os_} {precision}"
        outs[key] = pfb.channelize(x_dev, proto, N, os_, precision)
        ms = median_ms(lambda: pfb.channelize(x_dev, proto, N, os_, precision))
        rates[key] = PFB_SAMPLES / ms / 1e3
        if outs[key].shape != (os_ * PFB_SAMPLES // N, N) \
                or not torch.isfinite(outs[key].abs()).all():
            fail(f"channelize {key}: shape {tuple(outs[key].shape)} or "
                 f"non-finite values")
        small = 1 << 14
        cpu = pfb.channelize(torch.from_numpy(x[:small + hist]), proto, N,
                             os_, precision)
        _, err = errors(outs[key][:cpu.shape[0]].cpu(), cpu)
        print(f"channelize {key}: {ms:.3f} ms per call (median of 5, CUDA "
              f"events) = {rates[key]:.1f} Msamples/s of input; card vs CPU "
              f"on a 2^14 prefix max_rel_err={err:.3e} (tol 1e-5)", flush=True)
        if not err <= 1e-5:
            fail(f"channelize {key} on the card disagrees with the CPU")
    for os_ in (1, 2):
        ref = outs[f"os{os_} f32"]
        peak = ref.abs().max().item()
        if os_ == 1:
            e3 = (outs["os1 bf16x3"] - ref).abs().max().item() / peak
            print(f"channelize bf16x3 vs f32: max_err/peak={e3:.3e} (tol 1e-4)")
            if not e3 <= 1e-4:
                fail("channelize bf16x3 is not within 1e-4 of f32")
        d = outs[f"os{os_} bf16"] - ref
        snr = 10 * math.log10((ref.abs() ** 2).sum().item()
                              / (d.abs() ** 2).sum().item())
        print(f"channelize os{os_} bf16 vs f32: {snr:.2f} dB (gate 45 dB)")
        if not snr > 45.0:
            fail(f"channelize os{os_} bf16 SNR {snr:.2f} dB <= 45 dB")
    return rates


def run_arb_resampler(torch):
    """Phase 7b: arb_resample at the benchmark's two rates, 64 rows."""
    from fractions import Fraction

    from grtpu_torch.ops import pfb

    rates = {}
    for label, (p, q), n in ARB_CASES:
        rate = Fraction(p, q)
        taps = pfb.design_arb_resampler_taps(float(rate), 32)
        kp = -(-len(taps) // 32)
        f = 0.05
        ph0 = np.linspace(0, 2 * np.pi, ARB_ROWS, endpoint=False)[:, None]
        x = np.exp(1j * (2 * np.pi * f * np.arange(n + kp - 1)[None, :] + ph0)
                   ).astype(np.complex64)
        x_dev = torch.from_numpy(x).to("cuda")
        y = pfb.arb_resample(x_dev, taps, rate, 32)
        ms = median_ms(lambda: pfb.arb_resample(x_dev, taps, rate, 32))
        rates[label] = ARB_ROWS * n / ms / 1e3
        if y.shape != (ARB_ROWS, int(n * rate)):
            fail(f"arb_resample {label}: shape {tuple(y.shape)}")
        seg = y[:, 200:-200]
        dphi = torch.angle(seg[:, 1:] * torch.conj(seg[:, :-1])).mean(dim=1) \
            / (2 * math.pi)
        f_err = (dphi - f / float(rate)).abs().max().item()
        a_err = (seg.abs().mean(dim=1) - 1.0).abs().max().item()
        cpu = pfb.arb_resample(torch.from_numpy(x[:2, :q * 64 + kp - 1]), taps,
                               rate, 32)
        dev = pfb.arb_resample(x_dev[:2, :q * 64 + kp - 1], taps, rate, 32)
        _, err = errors(dev.cpu(), cpu)
        print(f"arb_resample {label}, {ARB_ROWS} rows x {n}: {ms:.3f} ms per "
              f"call (median of 5) = {rates[label]:.1f} Msamples/s of input; "
              f"tone frequency off by {f_err:.2e} (gate 1e-4), amplitude by "
              f"{a_err:.4f} (gate 0.05); card vs CPU max_rel_err={err:.3e}",
              flush=True)
        if not (f_err < 1e-4 and a_err < 0.05 and err <= 1e-5):
            fail(f"arb_resample {label} failed its fidelity gates")
    return rates


def run_pfb_graphs(torch):
    """Phase 7c: the filterbank blocks through the executor against the
    one-call ops (the history contract), and the analysis -> synthesis
    round trip."""
    from fractions import Fraction

    from grtpu_torch import StreamExecutor
    from grtpu_torch.blocks.pfb import PfbArbResampler, PfbChannelizer
    from grtpu_torch.ops import pfb
    from grtpu_torch.ops.fir import interp_fir_filter
    from grtpu_torch.utils import firdes

    n = PFB_STREAM
    rng = np.random.RandomState(8)
    x = torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                         .astype(np.complex64)).to("cuda")

    blk = PfbChannelizer(PFB_CHANNELS)
    outs, rates, _, _ = two_modes(
        torch, f"PfbChannelizer({PFB_CHANNELS}) graph",
        lambda: StreamExecutor(chain_graph(
            torch, [PfbChannelizer(PFB_CHANNELS)], torch.complex64),
            chunk_size=1 << 18, device="cuda"), (x,), n)
    y = outs[0]
    hist = blk.history - 1
    whole = pfb.channelize(torch.cat([x.new_zeros(hist), x]), blk.taps,
                           PFB_CHANNELS)
    _, err = errors(y, whole)
    print(f"PfbChannelizer({PFB_CHANNELS}) graph: {n} samples at "
          f"{rates['eager']:.1f} Msamples/s (chunk {1 << 18}); chunked vs "
          f"one-call max_rel_err={err:.3e} (tol 1e-5)", flush=True)
    if y.shape != (n // PFB_CHANNELS, PFB_CHANNELS) or not err <= 1e-5:
        fail("PfbChannelizer through the executor differs from channelize")

    blk = PfbArbResampler(160 / 147)
    chunk = 147 * 2048
    outs, rates, _, _ = two_modes(
        torch, "PfbArbResampler(160/147) graph",
        lambda: StreamExecutor(chain_graph(
            torch, [PfbArbResampler(160 / 147)], torch.complex64,
            [torch.complex64]), chunk_size=chunk, device="cuda"), (x,), n)
    y = outs[0]
    padded = -(-n // 147) * 147
    xin = torch.cat([x.new_zeros(blk.history - 1), x, x.new_zeros(padded - n)])
    whole = pfb.arb_resample(xin, blk.taps, Fraction(160, 147), 32)[:y.shape[0]]
    _, err = errors(y, whole)
    print(f"PfbArbResampler(160/147) graph: {n} samples at "
          f"{rates['eager']:.1f} Msamples/s (chunk {chunk}); chunked vs "
          f"one-call max_rel_err={err:.3e} (tol 1e-5)", flush=True)
    if y.shape[0] != int(n * Fraction(160, 147)) or not err <= 1e-5:
        fail("PfbArbResampler through the executor differs from arb_resample")

    # analysis -> synthesis at 16 channels (tests/test_pfb.py:59-103's gate)
    N = 16
    proto = firdes.root_raised_cosine(1.0, N, 1.0, 0.2, 14 * N)
    proto = (proto / proto.sum()).astype(np.float32)
    kp = -(-len(proto) // N)
    m, hist = 1 << 16, kp * N
    base = (rng.standard_normal(m // 2 + hist // 2 + 64)
            + 1j * rng.standard_normal(m // 2 + hist // 2 + 64))
    up_taps = firdes.low_pass(2.0, 2.0, 0.4, 0.2)
    xb = torch.cat([torch.zeros(-(-len(up_taps) // 2) - 1, dtype=torch.complex64),
                    torch.from_numpy(base.astype(np.complex64))]).to("cuda")
    sig = interp_fir_filter(xb, up_taps, 2)[: m + hist]
    ych = torch.cat([sig.new_zeros((kp - 1, N)), pfb.channelize(sig, proto, N)])
    rec = pfb.synthesize(ych, proto).cpu().numpy()
    xin = sig.cpu().numpy()[hist:]
    best = (1e9, 0)
    for lag in range(0, 3 * kp * N):
        k = min(len(rec) - lag, len(xin)) - 256
        a, b = xin[256: 256 + k], rec[lag + 256: lag + 256 + k]
        gain = np.vdot(b, a) / max(np.vdot(b, b).real, 1e-12)
        nmse = (np.abs(a - gain * b) ** 2).mean() / (np.abs(a) ** 2).mean()
        best = min(best, (float(nmse), lag))
    print(f"channelize -> synthesize, {N} channels, {m} samples: NMSE "
          f"{best[0]:.4f} at lag {best[1]} (gate 0.1)", flush=True)
    if not best[0] < 0.1:
        fail("channelize -> synthesize did not reconstruct the input")


def replay_events(torch, graph) -> int:
    """Device events of one replay of a captured graph (its nodes that ran:
    kernels, copies, fills), from torch.profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def graph_sizes(torch, ex) -> str:
    """Device events of one replay of each of an executor's captured graphs.
    The replay runs on the executor's static buffers; the next run copies
    the executor's state back in."""
    sizes = []
    for key, graph in ex._device_loop.graphs().items():
        n = replay_events(torch, graph)
        where = f"{'top' if key[0] is None else 'emission'} piece {key[1]}"
        sizes.append(f"{where}: {n} device events a replay" if n else
                     f"{where}: not measured (the profiler saw no event)")
    return "; ".join(sizes)


def run_sequential_loops(torch):
    """Phase 7d: the per-symbol and per-sample recursions on the card.  Each
    is a Python loop of one-element kernels: the rates are the host's."""
    from grtpu_torch import StreamExecutor
    from grtpu_torch.blocks import analog
    from grtpu_torch.blocks import pfb as pfb_blocks
    from grtpu_torch.ops.fir import interp_fir_filter
    from grtpu_torch.utils import firdes

    sps, nfilts, W, chunk = 4, 32, 32, 64
    rng = np.random.RandomState(9)
    nsym = SYNC_SAMPLES // sps
    bits = rng.randint(0, 2, nsym) * 2 - 1
    tx = firdes.root_raised_cosine(sps, sps, 1.0, 0.35, 11 * sps)
    xh = torch.cat([torch.zeros(-(-len(tx) // sps) - 1, dtype=torch.complex64),
                    torch.from_numpy((bits + 0j).astype(np.complex64))])
    wave = interp_fir_filter(xh, tx, sps).numpy()
    t = np.arange(len(wave))
    wave = (np.interp(t - 1.3, t, wave.real) + 0.02 * rng.standard_normal(len(t))
            + 1j * 0.02 * rng.standard_normal(len(t))).astype(np.complex64)
    mf = firdes.root_raised_cosine(nfilts, nfilts * sps, 1.0, 0.35,
                                   11 * sps * nfilts)
    kp = -(-len(mf) // nfilts)

    def sync_graph():
        blk = pfb_blocks.PfbClockSync(float(sps), 2 * np.pi / 100, mf, nfilts)
        return chain_graph(torch, [blk], torch.complex64, [torch.complex64])

    got = {"cpu": StreamExecutor(sync_graph(), chunk_size=SYNC_CHUNK,
                                 device="cpu").run(wave).numpy()}
    outs, _, loop_ex, _ = two_modes(
        torch, f"PfbClockSync, variable-rate executor, {SYNC_SAMPLES} samples "
        f"(chunk {SYNC_CHUNK})",
        lambda: StreamExecutor(sync_graph(), chunk_size=SYNC_CHUNK,
                               device="cuda"),
        (torch.from_numpy(wave).to("cuda"),), lambda y: y.shape[0],
        unit="symbols/s", per=1.0)
    got["cuda"] = outs[0].cpu().numpy()
    print(f"PfbClockSync under device_loop: "
          f"{graph_sizes(torch, loop_ex)}", flush=True)
    dec = {d: np.sign(v.real) for d, v in got.items()}
    acc = bit_accuracy(dec["cuda"], bits)
    same = dec["cuda"].shape == dec["cpu"].shape \
        and bool((dec["cuda"] == dec["cpu"]).all())
    print(f"PfbClockSync: decisions equal to the CPU run: {same}; bits "
          f"recovered {acc:.4f} (gate 0.98)", flush=True)
    if not same or not acc > 0.98:
        fail("PfbClockSync on the card disagrees with the CPU or lost the bits")

    xw = np.concatenate([np.zeros(W, np.complex64), wave])
    L = sps + 2 * W + kp
    T = (len(xw) - L) // sps + 1
    if T % chunk == 0:      # stay off the exact-multiple case (ROADMAP.md)
        xw = xw[:-sps]
    outs = {}
    for device in ("cpu", "cuda"):
        st = pfb_blocks.pfb_clock_sync_windowed_init(nfilts, device=device)
        xd = torch.from_numpy(xw).to(device)
        t0 = time.perf_counter()
        y, _ = pfb_blocks.pfb_clock_sync_chunked(
            xd, st, sps, mf, nfilts, 2 * np.pi / 100, W=W, chunk=chunk)
        outs[device] = y.cpu().numpy()
        dt = time.perf_counter() - t0
    same = bool((np.sign(outs["cuda"].real) == np.sign(outs["cpu"].real)).all())
    print(f"pfb_clock_sync_chunked: {len(outs['cuda'])} symbols in {dt:.3f} s "
          f"= {len(outs['cuda']) / dt:.1f} symbols/s; decisions equal to the "
          f"CPU run: {same}", flush=True)
    if not same or len(outs["cuda"]) < 0.9 * nsym:
        fail("pfb_clock_sync_chunked on the card disagrees with the CPU")

    x = (np.exp(1j * (0.2 * np.arange(LOOP_SAMPLES) + 0.7))
         * (1 + 0.5 * np.sin(np.arange(LOOP_SAMPLES) * 0.01))).astype(np.complex64)
    for name, make in (("Agc", lambda: analog.Agc(1e-3, 1.0, 0.5)),
                       ("PllRefout", lambda: analog.PllRefout(0.05, 0.5, -0.5))):
        def build(device):
            return StreamExecutor(chain_graph(
                torch, [make()], torch.complex64, [torch.complex64]),
                chunk_size=LOOP_CHUNK, device=device)

        ys = {"cpu": build("cpu").run(x).numpy()}
        outs, rates, _, _ = two_modes(
            torch, f"{name}, {LOOP_SAMPLES} samples (chunk {LOOP_CHUNK})",
            lambda: build("cuda"), (torch.from_numpy(x).to("cuda"),),
            LOOP_SAMPLES, unit="samples/s", per=1.0)
        ys["cuda"] = outs[0].cpu().numpy()
        err = float(np.abs(ys["cuda"] - ys["cpu"]).max())
        print(f"{name}: {LOOP_SAMPLES} samples at {rates['eager']:.1f} "
              f"samples/s eager (host-bound loop); card vs CPU "
              f"max_abs_err={err:.3e} (tol 1e-3)", flush=True)
        if not err <= 1e-3:
            fail(f"{name} on the card disagrees with the CPU run")


# --------------------------------------------------------- phase 9 (config 3)
PSK_CHANNELS = 256           # benchmarks/psk_bench.py:46-61
PSK_SAMPLES = 1 << 15
PSK_SPS = 2
PSK_SNR_DB = 20.0
PSK_SETTLE = 600
PSK_GATE = 0.02
PSK_ROUNDS = 3
EXACT_SAMPLES = 1 << 11      # GenericModem's exact chain, one channel
BERT_BITS = 1 << 10
LOOPBACK_BYTES = 400         # 3200 bits: the 2000-bit settle and 1000 more
LOOPBACK_CHUNK = 64          # bytes: 1024 samples at sps 4 a chunk
GMSK_CHUNK = 100
EQ_SYMBOLS = 4096
EQ_CHUNK = 512


def psk_bits(dec, modem) -> np.ndarray:
    """Symbol decisions -> bits: differential decode, ungray, MSB first."""
    dec = dec.astype(np.int64)
    d = (dec - np.concatenate([[0], dec[:-1]])) % modem.m
    out = modem.ungray_map[d]
    return ((out[:, None] >> np.arange(modem.k - 1, -1, -1)) & 1).reshape(-1)


def psk_bench_ber(sent, got, settle=PSK_SETTLE, min_len=1000):
    """psk_bench.py's BER: settle, then the best shift in -4..4 over at
    least ``min_len`` bits."""
    n = min(len(sent), len(got)) - settle
    best = 1.0
    for s in range(-4, 5):
        a = sent[settle: settle + n - 8]
        b = (got[settle + s: settle + s + n - 8] if s >= 0
             else got[settle + s:][: n - 8])
        m = min(len(a), len(b))
        if m > min_len:
            best = min(best, float((a[:m] != b[:m]).mean()))
    return best


def loopback_ber(data, got, settle=2000, max_lag=40):
    """BER after tests/test_vr_graph.py's 2000-bit settle, best lag.  Its
    bound there is 0 for a clean 20 dB burst; through ChannelModel's CFO
    and multipath the QPSK loops are still settling at bit 2000 (a few
    errors just past it), so that graph's gate is 0.01; GMSK's is
    test_vr_graph.py:340-356's 0.005."""
    bits = np.unpackbits(data)
    n = min(len(got), len(bits)) - max_lag
    return min(float((got[settle:n] != bits[settle - lag:n - lag]).mean())
               for lag in range(max_lag))


def run_psk_bank(torch):
    """Phase 9a: psk_bench's bank, 256 QPSK channels x 2^15 samples at sps
    2, through torch.func.vmap over GenericModem._demod_dev (chunked)."""
    from grtpu_torch.digital.generic_mod_demod import GenericModem

    C, N, sps = PSK_CHANNELS, PSK_SAMPLES, PSK_SPS
    modem = GenericModem(m=4, samples_per_symbol=sps, chunked=True,
                         device="cuda")
    t0 = time.perf_counter()
    r = np.random.RandomState(0)
    bits0 = r.randint(0, 2, (N // sps) * 2 + 64).astype(np.uint8)
    tx0 = modem.modulate(bits0).cpu().numpy()
    namp = np.sqrt((np.abs(tx0) ** 2).mean() / (2 * 10 ** (PSK_SNR_DB / 10)))
    chans = np.zeros((C, N), np.complex64)
    for c in range(C):
        w = tx0[:N] * np.exp(1j * (c - C / 2) * 2e-5 * np.arange(N))
        chans[c] = (w + namp * (r.randn(N) + 1j * r.randn(N))).astype(
            np.complex64)
    X = torch.from_numpy(chans).to("cuda")
    print(f"PSK bank: {C} channels x {N} samples, QPSK at sps {sps}, "
          f"{PSK_SNR_DB:g} dB, CFO (c - {C // 2}) * 2e-5 rad/sample, made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the chain's four stages, each vmapped: run eagerly in turn (the same
    # ops as one vmapped _demod_dev call), then each captured into a CUDA
    # graph of its own, fed a copy of its eager input, and replayed: the
    # card's time for the stage without the host's cost of dispatching it
    stages = (("agc", modem._agc), ("fll", lambda v: modem._fll(v)[0]),
              ("clock", lambda v: modem._clock(v)[0]),
              ("receiver", modem._receiver))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ins, v = [], X
    for _, fn in stages:
        ins.append(v)
        v = torch.func.vmap(fn)(v)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    syms = v.cpu().numpy()
    bers = np.array([psk_bench_ber(bits0, psk_bits(syms[c], modem))
                     for c in range(C)])
    print(f"PSK bank BER over channels (psk_bench's settle {PSK_SETTLE} and "
          f"shift search): min {bers.min():.5f}, median {np.median(bers):.5f}"
          f", max {bers.max():.5f}; channel 3 {bers[3]:.5f} (gate "
          f"{PSK_GATE} for channel 3 and the median)", flush=True)
    if not (bers[3] < PSK_GATE and np.median(bers) < PSK_GATE):
        fail("the PSK bank did not lock: BER over its gate")

    ms, caps, same = {}, {}, {}
    outs = ins[1:] + [v]
    for (name, fn), inp, want in zip(stages, ins, outs):
        static = inp.clone()
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            got = torch.func.vmap(fn)(static)
        caps[name] = time.perf_counter() - t0
        ms[name] = median_ms(graph.replay, PSK_ROUNDS)
        same[name] = torch.equal(got, want)
        del graph, got, static
    total = sum(ms.values())
    print("PSK bank stages replayed from CUDA graphs (median of "
          f"{PSK_ROUNDS}, ms a call; capture s): "
          + ", ".join(f"{n} {ms[n]:.3f} ({caps[n]:.2f} s)" for n in ms)
          + f"; whole chain {total:.3f} ms = {C * N / total / 1e3:.2f} "
          f"Msamples/s aggregate; each replay equal to its eager stage: "
          f"{same}", flush=True)
    print(f"PSK bank: eager (vmapped, dispatched from the host) "
          f"{eager_s * 1e3:.1f} ms a call = {C * N / eager_s / 1e6:.2f} "
          f"Msamples/s; stage shares of the replayed chain: "
          + ", ".join(f"{n} {ms[n] / total:.3f}" for n in ms), flush=True)
    if not all(same.values()):
        fail("a PSK bank stage's graph replay differs from its eager run")
    return bers


def run_exact_forms(torch):
    """Phase 9b: the exact (per-sample, per-symbol) chain on one channel,
    on the card and on the CPU: GenericModem and the BERT loopback."""
    from grtpu_torch.digital.bert import bert_loopback
    from grtpu_torch.digital.generic_mod_demod import GenericModem

    kw = dict(m=4, samples_per_symbol=4)
    r = np.random.RandomState(1)
    bits = r.randint(0, 2, EXACT_SAMPLES // 2).astype(np.uint8)
    x = GenericModem(device="cpu", **kw).modulate(bits).numpy()
    x = (x * np.exp(1j * 0.003 * np.arange(len(x)))
         + 0.05 * (r.randn(len(x)) + 1j * r.randn(len(x)))).astype(np.complex64)
    got, secs = {}, {}
    for device in ("cuda", "cpu"):
        modem = GenericModem(device=device, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[device] = modem.demodulate(x)
        secs[device] = time.perf_counter() - t0
    nsym = len(got["cuda"]) // 2
    same = np.array_equal(got["cuda"], got["cpu"])
    ber = psk_bench_ber(bits, got["cuda"], settle=300, min_len=500)
    print(f"GenericModem exact, {len(x)} samples (QPSK sps 4, CFO, noise): "
          f"{nsym} symbols at {nsym / secs['cuda']:.1f} symbols/s on the card "
          f"({nsym / secs['cpu']:.1f} on the CPU); decisions equal to the "
          f"CPU's: {same}; BER {ber:.4f} (gate 0.02)", flush=True)
    if not same or not ber < 0.02:
        fail("GenericModem's exact chain disagrees with the CPU or lost lock")

    cfo = -0.002
    res = {}
    for device in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ber, rx = bert_loopback(nbits=BERT_BITS, m=2, sps=4, snr_db=10.0,
                                cfo=cfo, settle=BERT_BITS // 4, device=device)
        res[device] = (ber, rx, time.perf_counter() - t0)
    ber, rx, dt = res["cuda"]
    same = (ber == res["cpu"][0]
            and rx.density() == res["cpu"][1].density())
    foff = rx.frequency_offset()
    print(f"bert_loopback {BERT_BITS} bits, BPSK sps 4, 10 dB, CFO {cfo}: BER "
          f"{ber:.4f} (gate 0.05), FLL offset {foff:.5f}, SNR probe "
          f"{rx.snr():.2f} dB, {BERT_BITS / dt:.1f} symbols/s on the card; "
          f"equal to the CPU run: {same}", flush=True)
    if not (same and ber < 0.05 and 5.0 < rx.snr() < 30.0
            and (abs(foff + cfo) < 8e-4 or abs(foff) < 25e-4)):
        fail("bert_loopback on the card failed a gate or left the CPU's run")


def run_loopback_graphs(torch):
    """Phase 9c: config #3's graphs through the executor, eager and under
    device_loop: generic QPSK and GMSK, each through ChannelModel."""
    from grtpu_torch import StreamExecutor
    from grtpu_torch.digital import generic_mod_demod as gm
    from grtpu_torch.models.channel import ChannelModel

    data = np.random.RandomState(2).randint(0, 256, LOOPBACK_BYTES).astype(
        np.uint8)
    data_dev = torch.from_numpy(data).to("cuda")
    cases = (
        ("GenericModBlock -> ChannelModel -> GenericDemodBlock (QPSK sps 4)",
         lambda: [gm.GenericModBlock(m=4, samples_per_symbol=4),
                  ChannelModel(noise_voltage=0.05, frequency_offset=5e-4,
                               taps=(1.0, 0.1j)),
                  gm.GenericDemodBlock(m=4, samples_per_symbol=4)],
         LOOPBACK_CHUNK, 0.01),
        ("GmskModBlock -> ChannelModel -> GmskDemodBlock (sps 2)",
         lambda: [gm.GmskModBlock(2), ChannelModel(noise_voltage=0.05),
                  gm.GmskDemodBlock(2)], GMSK_CHUNK, 0.005))
    for label, chain, chunk, gate in cases:
        # one run a mode (the eager run is the slow one), then one more
        # device_loop run that only replays
        outs, _, loop_ex, _ = two_modes(
            torch, f"{label}, {LOOPBACK_BYTES} bytes (chunk {chunk})",
            lambda: StreamExecutor(chain_graph(torch, chain(), torch.uint8,
                                               [torch.uint8]),
                                   chunk_size=chunk, device="cuda"),
            (data_dev,), lambda y: y.shape[0], unit="bits/s", per=1.0, runs=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = loop_ex.run(data_dev, device_loop=True)
        torch.cuda.synchronize()
        ber = loopback_ber(data, outs[0].cpu().numpy())
        print(f"{label}: device_loop, replays only: "
              f"{y.shape[0] / (time.perf_counter() - t0):.2f} bits/s; BER "
              f"{ber:.4f} after the 2000-bit settle (gate {gate}); under "
              f"device_loop: {graph_sizes(torch, loop_ex)}", flush=True)
        if not ber <= gate:
            fail(f"{label}: BER {ber} over its gate")


def run_equalizers(torch):
    """Phase 9d: LmsDdEqualizer and CmaEqualizer on a multipath QPSK
    stream, eager and under device_loop (tests/test_digital.py:259-298)."""
    from grtpu_torch import StreamExecutor
    from grtpu_torch.digital.constellation import constellation_qpsk
    from grtpu_torch.digital.equalizers import CmaEqualizer, LmsDdEqualizer

    c = constellation_qpsk()
    syms = c.points[np.random.RandomState(3).randint(0, 4, EQ_SYMBOLS)]
    h = np.array([1.0, 0.0, 0.25 - 0.12j], np.complex64)
    rx = np.convolve(syms, h)[:EQ_SYMBOLS].astype(np.complex64)
    half = EQ_SYMBOLS // 2
    for label, make in (("LmsDdEqualizer", lambda: LmsDdEqualizer(c, 11, 0.01)),
                        ("CmaEqualizer", lambda: CmaEqualizer(11, 1.0, 0.005))):
        outs, _, _, _ = two_modes(
            torch, f"{label}, {EQ_SYMBOLS} symbols (chunk {EQ_CHUNK})",
            lambda: StreamExecutor(chain_graph(torch, [make()],
                                               torch.complex64),
                                   chunk_size=EQ_CHUNK, device="cuda"),
            (torch.from_numpy(rx).to("cuda"),), EQ_SYMBOLS,
            unit="samples/s", per=1.0)
        y = outs[0].cpu().numpy()[half:]
        r0 = rx[half:]
        if label == "CmaEqualizer":
            before = np.abs(np.abs(r0) ** 2 - 1.0).mean()
            after = np.abs(np.abs(y) ** 2 - 1.0).mean()
        else:
            before = np.abs(r0 - c.points[c.decision_maker(r0).numpy()]).mean()
            after = np.abs(y - c.points[c.decision_maker(y).numpy()]).mean()
        print(f"{label}: eye error {before:.4f} before, {after:.4f} after "
              f"(gate: halved)", flush=True)
        if not after < 0.5 * before:
            fail(f"{label} did not open the eye")


def run_noise_resume(torch):
    """Phase 9e: a ChannelModel's noise resumed from a checkpoint under
    device_loop continues the uninterrupted run bit for bit."""
    import tempfile

    from grtpu_torch import StreamExecutor
    from grtpu_torch.models.channel import ChannelModel

    def build():
        return StreamExecutor(chain_graph(torch, [ChannelModel(
            noise_voltage=0.2, frequency_offset=0.002)], torch.complex64),
            chunk_size=4096, device="cuda")

    x = torch.from_numpy(np.exp(0.1j * np.arange(1 << 16)).astype(
        np.complex64)).to("cuda")
    want = build().run(x)
    ex = build()
    first = ex.run(x[: 1 << 15], device_loop=True)
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "ckpt.npz")
        ex.save_checkpoint(path)
        resumed = build()
        resumed.load_checkpoint(path)
    second = resumed.run(x[1 << 15:], device_loop=True)
    same = torch.equal(torch.cat([first, second]), want)
    print(f"ChannelModel noise resumed from a checkpoint after 8 of 16 "
          f"chunks, under device_loop: torch.equal to the uninterrupted "
          f"run: {same}", flush=True)
    if not same:
        fail("the resumed noise stream left the uninterrupted run")


OVERHEAD_BLOCKS = 20       # benchmarks/executor_overhead_bench.py's chain
OVERHEAD_CHUNK = 4096
OVERHEAD_CHUNKS = 256


def run_executor_overhead(torch):
    """Phase 8: the executor's own cost a chunk, on a chain of 20 Copy
    blocks (they launch nothing: the step's work is the executor's), chunk
    4096, 256 chunks, eagerly and under device_loop."""
    from grtpu_torch import StreamExecutor
    from grtpu_torch.blocks.stream import Copy

    x = torch.arange(OVERHEAD_CHUNKS * OVERHEAD_CHUNK, dtype=torch.float32,
                     device="cuda")
    outs, rates, loop_ex, _ = two_modes(
        torch, f"executor overhead, {OVERHEAD_BLOCKS} Copy blocks",
        lambda: StreamExecutor(chain_graph(
            torch, [Copy() for _ in range(OVERHEAD_BLOCKS)], torch.float32),
            chunk_size=OVERHEAD_CHUNK, device="cuda"),
        (x,), OVERHEAD_CHUNKS, unit="chunks/s", per=1.0)
    if not torch.equal(outs[0], x):
        fail("the Copy chain changed its input")
    us = {m: 1e6 / r for m, r in rates.items()}
    print(f"executor overhead, {OVERHEAD_BLOCKS} Copy blocks, chunk "
          f"{OVERHEAD_CHUNK}: eager {us['eager']:.1f} us a chunk, device_loop "
          f"{us['device_loop']:.1f} us a chunk (host clock around run() of "
          f"{OVERHEAD_CHUNKS} chunks, synchronized)", flush=True)

    # where a device_loop chunk's host time goes: each part alone, 1000
    # calls on the host clock without a synchronize between them (they run
    # on the executor's static buffers; the next run copies its state in)
    loop = loop_ex._device_loop
    graph = next(iter(loop.graphs().values()))
    chunk = x[:OVERHEAD_CHUNK]
    parts = {"copy in": lambda: loop.inputs[0].copy_(chunk),
             "replay": graph.replay,
             "copy out": lambda: loop.inputs[0].clone(),
             "whole step": lambda: loop.step(chunk)}
    cost = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        cost[name] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    print("device_loop host cost a chunk, 20 Copy blocks: "
          + ", ".join(f"{k} {v:.2f} us" for k, v in cost.items())
          + " (1000 calls each, host clock, no synchronize)", flush=True)
    return us


# ----------------------------------------------- phase 10 (packets, tags, OFDM)
PKT_BYTES = 256              # PacketEncoder's default payload
PKT_FLOATS = 1 << 16         # 1024 packets of 64 floats
PKT_CHUNK = 4096
PKT_MSGS = 32
OFDM_NSYM = 8                # benchmarks/ofdm_bench.py:35-80
OFDM_FRAMES = 24
OFDM_SNR_DB = 20.0
OFDM_CFO = 0.002
OFDM_WIDTHS = (("10b", 64, 48, 16), ("10c", 512, 200, 128))  # fft, tones, cp
OFDM_BANK = 64               # ofdm_bench.py's bank_rate(64, 16, 16)
OFDM_BANK_SPANS = 16
OFDM_BANK_CHUNKS = 2
OFDM_BER_GATE = 1e-3
OFDM_CHAN_TOL = 1e-4         # card vs CPU channel estimate, relative


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = fn()
    torch.cuda.synchronize()
    return y, time.perf_counter() - t0


def packet_tag_graph(torch):
    """PacketEncoder -> bits -> CorrelateAccessCodeTag -> PacketDecoder."""
    from grtpu_torch import Graph
    from grtpu_torch.runtime.block import Port
    from grtpu_torch.blocks.gengen import PackedToUnpacked
    from grtpu_torch.digital.correlate import CorrelateAccessCodeTag
    from grtpu_torch.digital.packet import DEFAULT_ACCESS_CODE_BITS
    from grtpu_torch.digital.packet_blocks import PacketDecoder, PacketEncoder

    g = Graph()
    pin = g.add_input(Port(torch.float32))
    pout = g.add_output(Port(torch.float32))
    dec = PacketDecoder("float", payload_length=PKT_BYTES, name="dec")
    g.connect(pin, PacketEncoder("float", PKT_BYTES, name="enc"),
              PackedToUnpacked(1, name="unpack"),
              CorrelateAccessCodeTag(DEFAULT_ACCESS_CODE_BITS, key="sync",
                                     name="cat"), dec, pout)
    return g, dec


def run_packets_and_tags(torch):
    """Phase 10a: the packet chain with stream tags in flight, eager and
    under device_loop, against the CPU run; the framer and packet sinks'
    messages."""
    from grtpu_torch import StreamExecutor
    from grtpu_torch.runtime.tags import Tag

    x = np.random.RandomState(10).standard_normal(PKT_FLOATS).astype(np.float32)
    per_pkt = PKT_BYTES // 4
    in_tags = [Tag(100, "in", 1), Tag(30000, "in", 2), Tag(65000, "in", 3)]

    def first_run(device, device_loop):
        g, dec = packet_tag_graph(torch)
        ex = StreamExecutor(g, chunk_size=PKT_CHUNK, vr_chunks={dec: per_pkt},
                            device=device)
        ex.add_tags(0, in_tags)
        y = ex.run(torch.from_numpy(x).to(device), device_loop=device_loop)
        return ex, y, sorted((t.offset, t.key, repr(t.value), t.srcid)
                             for t in ex.pad_tags.get(0, []))

    _, y_cpu, tags_cpu = first_run("cpu", False)
    x_dev = torch.from_numpy(x).to("cuda")
    res = {}
    for mode in ("eager", "device_loop"):
        # the first run (device_loop: with its captures) carries the tags
        # compared below; the second, on the same executor, is timed
        ex, y, tags = first_run("cuda", mode == "device_loop")
        _, dt = timed(torch, lambda: ex.run(
            x_dev, device_loop=mode == "device_loop"))
        res[mode] = (ex, y, tags, dt)
    n_sync = sum(k == "sync" for _, k, _, _ in tags_cpu)
    for mode, (ex, y, tags, dt) in res.items():
        print(f"packets + tags ({mode}): {PKT_FLOATS} floats in "
              f"{PKT_FLOATS // per_pkt} packets of {PKT_BYTES} bytes, chunk "
              f"{PKT_CHUNK}: {PKT_FLOATS / dt / 1e6:.3f} Msamples/s of input "
              f"({len(tags)} tags at the output pad, {n_sync} from "
              f"CorrelateAccessCodeTag)", flush=True)
    loop = res["device_loop"][0]._device_loop
    print(f"packets + tags device_loop: {len(loop.graphs())} graphs captured "
          f"in {loop.stats['capture_s']:.3f} s; "
          f"{graph_sizes(torch, res['device_loop'][0])}", flush=True)
    same = (torch.equal(res["eager"][1], res["device_loop"][1])
            and torch.equal(res["eager"][1].cpu(), y_cpu))
    tags_same = res["eager"][2] == res["device_loop"][2] == tags_cpu
    print(f"packets + tags: payloads torch.equal eager / device_loop / CPU: "
          f"{same}; tags, offsets and keys identical: {tags_same}", flush=True)
    if not same or not tags_same:
        fail("packets + tags differ between the modes or from the CPU")
    if not (len(y_cpu) == PKT_FLOATS
            and np.array_equal(y_cpu.numpy(), x)):
        fail(f"packets: {len(y_cpu)} of {PKT_FLOATS} floats came back "
             f"(a packet failed its CRC or was lost)")
    n_in = sum(t.offset < PKT_FLOATS for t in in_tags)
    if n_sync != PKT_FLOATS // per_pkt or len(tags_cpu) != n_sync + n_in:
        fail(f"tags: {n_sync} access-code tags and {len(tags_cpu)} in all")
    print(f"packets: all {PKT_FLOATS // per_pkt} packets passed their CRC",
          flush=True)
    run_framer_sinks(torch)


def run_framer_sinks(torch):
    """FramerSink and PacketSink deliver each frame to a MsgQueue: the same
    messages, typed header included, eager, under device_loop and on the
    CPU."""
    from grtpu_torch import Graph, StreamExecutor
    from grtpu_torch.runtime.block import Port
    from grtpu_torch.digital import packet
    from grtpu_torch.digital.correlate import (CorrelateAccessCode,
                                               FramerSink, PacketSink)

    rng = np.random.RandomState(11)
    payloads = [bytes(rng.randint(0, 256, rng.randint(16, 200)).astype(np.uint8))
                for _ in range(PKT_MSGS)]
    parts = []
    for i, p in enumerate(payloads):
        parts += [rng.randint(0, 2, 50 + i).astype(np.uint8),
                  packet.make_packet(p, whitener_offset=i % 16)]
    bits = np.concatenate(parts + [np.zeros(100, np.uint8)])
    chunk = 4096
    bits = np.concatenate([bits, np.zeros(-len(bits) % chunk, np.uint8)])
    got = {}
    for kind in ("framer", "packet"):
        for device, mode in (("cpu", "eager"), ("cuda", "eager"),
                             ("cuda", "device_loop")):
            g = Graph()
            pin = g.add_input(Port(torch.uint8))
            if kind == "framer":
                sink = FramerSink()
                g.connect(pin, CorrelateAccessCode(
                    packet.DEFAULT_ACCESS_CODE_BITS, 0), sink)
            else:
                sink = PacketSink(threshold=0)
                g.connect(pin, sink)
            ex = StreamExecutor(g, chunk_size=chunk, device=device)
            ex.run(bits, device_loop=mode == "device_loop")
            msgs = []
            while (m := sink.msgq.delete_head_nowait()) is not None:
                msgs.append((m.to_string(), m.kind, m.arg1, m.arg2))
            got[kind, device, mode] = msgs
    ok = all(v == got["framer", "cpu", "eager"] for v in got.values())
    plain = [packet.unmake_packet(np.unpackbits(np.frombuffer(m[0], np.uint8)),
                                  i % 16)
             for i, m in enumerate(got["framer", "cpu", "eager"])]
    crc = [p for good, p in plain if good]
    print(f"FramerSink / PacketSink: {len(got['framer', 'cpu', 'eager'])} "
          f"messages each (kind, arg1, arg2 = "
          f"{got['framer', 'cpu', 'eager'][0][1:]}), the same eager, under "
          f"device_loop and on the CPU: {ok}; {len(crc)} of {PKT_MSGS} pass "
          f"unmake_packet's CRC", flush=True)
    if not ok or crc != payloads:
        fail("the framer / packet sinks' messages differ or fail their CRC")


def ofdm_frames(modem, nsym, nframes, seed=0, snr_db=OFDM_SNR_DB, cfo=OFDM_CFO):
    """benchmarks/ofdm_bench.py's stream: each frame after 200 zeros, CFO
    and AWGN, 1200 zeros at the end.  Returns (stream, [bits a frame])."""
    rng = np.random.RandomState(seed)
    sigs, bits_all = [], []
    for _ in range(nframes):
        bits = rng.randint(0, 2, nsym * modem.occupied * 2).astype(np.uint8)
        tx = modem.modulate(bits)
        sig = np.concatenate([np.zeros(200, np.complex64), tx])
        n = len(sig)
        sig = sig * np.exp(1j * cfo * np.arange(n))
        n0 = (np.abs(tx) ** 2).mean() / 10 ** (snr_db / 10)
        sig = (sig + (rng.randn(n) + 1j * rng.randn(n)) * np.sqrt(n0 / 2)
               ).astype(np.complex64)
        sigs.append(sig)
        bits_all.append(bits)
    return (np.concatenate(sigs + [np.zeros(1200, np.complex64)])
            .astype(np.complex64), bits_all)


def ofdm_graph(torch, modem, nsym, spans):
    """pad -> OfdmReceiver -> (OfdmFrameSink -> bits, flags, channel
    estimate); returns (graph, receiver, a chunk of ``spans`` frame spans)."""
    from grtpu_torch import Graph
    from grtpu_torch.runtime.block import Port
    from grtpu_torch.digital.ofdm import OfdmFrameSink, OfdmReceiver

    rx = OfdmReceiver(modem, nsym_data=nsym, sync_type="pn")
    g = Graph()
    pin = g.add_input(Port(torch.complex64))
    outs = [g.add_output(Port(torch.uint8)), g.add_output(Port(torch.uint8)),
            g.add_output(Port(torch.complex64, modem.occupied))]
    g.connect(pin, rx)
    g.connect((rx, 0), OfdmFrameSink(modem), outs[0])
    g.connect((rx, 1), outs[1])
    g.connect((rx, 2), outs[2])
    return g, rx, spans * (nsym + 2) * rx.sym_len


def frame_ber(bits_out, bits_all):
    per = len(bits_all[0])
    nfr = min(len(bits_out) // per, len(bits_all))
    errs = sum(int((bits_out[i * per:(i + 1) * per] != b).sum())
               for i, b in enumerate(bits_all[:nfr]))
    return errs / max(nfr * per, 1), nfr


def run_ofdm_stream(torch, label, fft, occ, cp):
    """Phases 10b / 10c: the OFDM receiver graph at one width."""
    from grtpu_torch import StreamExecutor
    from grtpu_torch.digital.ofdm import OfdmModem

    modem = OfdmModem(fft, cp, occ, device="cpu")
    x, bits_all = ofdm_frames(modem, OFDM_NSYM, OFDM_FRAMES)

    def build(device):
        g, rx, chunk = ofdm_graph(torch, modem, OFDM_NSYM, 4)
        return StreamExecutor(g, chunk_size=chunk,
                              vr_chunks={rx: 4 * OFDM_NSYM}, device=device)

    ref = build("cpu").run(x)
    x_dev = torch.from_numpy(x).to("cuda")
    outs, rates, ex, _ = two_modes(
        torch, f"OFDM {label} fft {fft} / {occ} tones / cp {cp}, "
        f"{OFDM_FRAMES} frames of {OFDM_NSYM} symbols",
        lambda: build("cuda"), (x_dev,), len(x))
    print(f"OFDM {label} device_loop graphs: {graph_sizes(torch, ex)}",
          flush=True)
    bits, flags, chan = (t.cpu() for t in outs[-1])
    ber, nfr = frame_ber(bits.numpy(), bits_all)
    err = (float((chan - ref[2]).abs().max() / ref[2].abs().max())
           if chan.shape == ref[2].shape else math.inf)
    same_cpu = torch.equal(bits, ref[0]) and torch.equal(flags, ref[1])
    print(f"OFDM {label}: {int(flags.sum())} of {OFDM_FRAMES} frames found, "
          f"BER {ber:.3e} over {nfr} frames (gate {OFDM_BER_GATE:g}); bits "
          f"and flags equal to the CPU run: {same_cpu}; channel estimate "
          f"card vs CPU max_rel_err={err:.3e} (tol {OFDM_CHAN_TOL:g})",
          flush=True)
    if int(flags.sum()) != OFDM_FRAMES or nfr != OFDM_FRAMES:
        fail(f"OFDM {label}: {int(flags.sum())} frames found")
    if not ber <= OFDM_BER_GATE or not err <= OFDM_CHAN_TOL:
        fail(f"OFDM {label}: BER {ber}, channel estimate off by {err}")
    return rates


def run_ofdm_bank(torch):
    """Phase 10d: OfdmReceiver.apply vmapped over 64 channels, chunk 16
    frame spans, eager and replayed from one CUDA graph; each channel's
    bits equal to its single-stream run through the executor."""
    from grtpu_torch import StreamExecutor
    from grtpu_torch.digital.ofdm import OfdmFrameSink, OfdmModem

    C = OFDM_BANK
    modem = OfdmModem(device="cpu")
    g, rx, chunk = ofdm_graph(torch, modem, OFDM_NSYM, OFDM_BANK_SPANS)
    n = OFDM_BANK_CHUNKS * chunk
    t0 = time.perf_counter()
    streams, sent = [], []
    for c in range(C):
        nfr = n // (200 + (OFDM_NSYM + 2) * rx.sym_len)
        s, b = ofdm_frames(modem, OFDM_NSYM, nfr, seed=100 + c)
        streams.append(s[:n])
        sent.append(b)
    X = torch.from_numpy(np.stack(streams)).to("cuda")
    print(f"OFDM bank: {C} channels x {n} samples ({OFDM_BANK_CHUNKS} chunks "
          f"of {OFDM_BANK_SPANS} frame spans) made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    h = rx.history - 1
    init = {k: v.to("cuda") for k, v in rx.init_state().items()}
    vapply = torch.func.vmap(rx.apply)

    def fresh():
        return {k: v.expand((C,) + v.shape).clone() for k, v in init.items()}

    def chunk_in(tail, c):
        return torch.cat([tail, X[:, c * chunk:(c + 1) * chunk]], 1)

    # eager: the vmapped apply dispatched from the host
    st, tail, eager = fresh(), torch.zeros(C, h, dtype=torch.complex64,
                                           device="cuda"), []
    vapply(fresh(), chunk_in(tail, 0))            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(OFDM_BANK_CHUNKS):
        xin = chunk_in(tail, c)
        tail = xin[:, -h:]
        st, (ys, nv) = vapply(st, xin)
        eager.append((ys, nv))
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / OFDM_BANK_CHUNKS
    # one CUDA graph of the vmapped step over static buffers, replayed
    sst, sx = fresh(), torch.zeros(C, h + chunk, dtype=torch.complex64,
                                   device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        vapply(fresh(), sx)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph):
        out_st, (out_ys, out_nv) = vapply(sst, sx)
    capture_s = time.perf_counter() - t0
    tail = torch.zeros(C, h, dtype=torch.complex64, device="cuda")
    same, rows = True, []
    for c in range(OFDM_BANK_CHUNKS):
        sx.copy_(chunk_in(tail, c))
        tail = sx[:, -h:].clone()
        graph.replay()
        same &= torch.equal(out_nv, eager[c][1]) and all(
            torch.equal(a, b) for a, b in zip(out_ys, eager[c][0]))
        rows.append((out_ys[0].clone(), out_ys[1].clone(), out_nv.clone()))
        for k in sst:
            sst[k].copy_(out_st[k])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    times = []
    for _ in range(5):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    replay_ms = float(np.median(times))
    print(f"OFDM bank: eager (vmapped, dispatched from the host) "
          f"{eager_ms:.3f} ms a chunk = {C * chunk / eager_ms / 1e3:.2f} "
          f"Msamples/s; replayed from one CUDA graph (captured in "
          f"{capture_s:.3f} s, {replay_events(torch, graph)} device events "
          f"a replay) {replay_ms:.3f} ms a chunk (median of 5) = "
          f"{C * chunk / replay_ms / 1e3:.2f} Msamples/s aggregate; replay "
          f"torch.equal to eager: {same}", flush=True)
    if not same:
        fail("OFDM bank: the replayed graph differs from the eager vmapped call")

    # each channel alone through the executor (one capture, a replay per run)
    sink = OfdmFrameSink(modem)
    ex = StreamExecutor(g, chunk_size=chunk, vr_chunks={rx: OFDM_NSYM},
                        device="cuda")
    start_state = ex.state
    equal, errs, nbits, frames = 0, 0, 0, 0
    for ch in range(C):
        ex.state = start_state
        ref_bits, ref_flags, _ = ex.run(X[ch], device_loop=True)
        bank_bits = torch.cat([sink.apply((), r[0][ch][: int(r[2][ch])])[1]
                               for r in rows])
        bank_flags = torch.cat([r[1][ch][: int(r[2][ch])] for r in rows])
        k = len(ref_bits)
        equal += int(torch.equal(bank_bits[:k], ref_bits)
                     and torch.equal(bank_flags[: len(ref_flags)], ref_flags))
        b = bank_bits.cpu().numpy()
        e, nfr = frame_ber(b, sent[ch])
        errs += e * nfr * len(sent[ch][0])
        nbits += nfr * len(sent[ch][0])
        frames += int(bank_flags.sum())
    ber = errs / max(nbits, 1)
    print(f"OFDM bank: {equal} of {C} channels' bits equal to their "
          f"single-stream run; {frames} frames found, BER {ber:.3e} over "
          f"{nbits} bits (gate {OFDM_BER_GATE:g})", flush=True)
    want = sum(len(b) for b in sent)
    if equal != C or frames != want or not ber <= OFDM_BER_GATE:
        fail(f"OFDM bank: {equal} channels equal to their single-stream run, "
             f"{frames} of {want} frames, BER {ber}")


def run_ofdm_packets(torch):
    """Phase 10e: OfdmPacketModem bursts -> the receiver -> parse_frames;
    one frame corrupted on purpose."""
    from grtpu_torch import StreamExecutor
    from grtpu_torch.digital.ofdm import OfdmModem, OfdmPacketModem

    modem = OfdmModem(device="cpu")
    pm = OfdmPacketModem(modem, OFDM_NSYM)
    rng = np.random.RandomState(12)
    payloads = [bytes(rng.randint(0, 256, rng.randint(1, pm.max_payload + 1))
                      .astype(np.uint8)) for _ in range(16)]
    bad_at = 8
    sigs = []
    for i, p in enumerate(payloads):
        burst = pm.make_burst(p, whitener_offset=i % 16)
        if i == bad_at:              # smash two data symbols
            burst[3 * 80: 5 * 80] = 0.3 + 0.1j
        sigs.append(np.concatenate([np.zeros(150, np.complex64), burst]))
    x = np.concatenate(sigs + [np.zeros(2500, np.complex64)])
    n = len(x)
    sigma = np.sqrt((np.abs(np.concatenate(sigs)) ** 2).mean() / 100 / 2)
    x = (x * np.exp(2j * np.pi * 1.5e-4 * np.arange(n)) + sigma * (
        rng.randn(n) + 1j * rng.randn(n))).astype(np.complex64)
    got, rate = {}, {}
    x_dev = torch.from_numpy(x).to("cuda")
    for mode in ("eager", "device_loop"):
        g, rx, chunk = ofdm_graph(torch, modem, OFDM_NSYM, 4)
        ex = StreamExecutor(g, chunk_size=chunk, vr_chunks={rx: OFDM_NSYM},
                            device="cuda")
        start = ex.state
        for _ in range(2):           # the second run is timed
            ex.state = start
            (bits, flags, _), dt = timed(torch, lambda: ex.run(
                x_dev, device_loop=mode == "device_loop"))
        rate[mode] = len(x) / dt / 1e6
        got[mode] = pm.parse_frames(bits, flags)
    loop = ex._device_loop
    print(f"OfdmPacketModem receive, {len(x)} samples: eager "
          f"{rate['eager']:.2f} Msamples/s, device_loop "
          f"{rate['device_loop']:.2f} Msamples/s ({len(loop.graphs())} graphs "
          f"captured in {loop.stats['capture_s']:.3f} s; {graph_sizes(torch, ex)})",
          flush=True)
    res = got["eager"]
    good = [i for i, (ok, m) in enumerate(res) if ok and m == payloads[i]]
    failed = [i for i, (ok, _) in enumerate(res) if not ok]
    print(f"OfdmPacketModem: {len(res)} frames parsed, {len(good)} passed "
          f"their CRC with the payload sent, {len(failed)} failed (frame "
          f"{failed}, corrupted on purpose: {bad_at}); device_loop parsed the "
          f"same: {got['device_loop'] == res}", flush=True)
    if (len(res) != len(payloads) or failed != [bad_at]
            or len(good) != len(payloads) - 1 or got["device_loop"] != res):
        fail("OfdmPacketModem: a frame was lost, a CRC failed, or the "
             "corrupted frame passed")


# ------------------------------------- phase 11 (trellis, FEC, ATSC: config #5)
TRELLIS_B, TRELLIS_K = 4096, 512     # benchmarks/trellis_bench.py
SCCC_B, SCCC_K, SCCC_IT = 1024, 512, 8
TRELLIS_GRAPH_K, TRELLIS_GRAPH_BLOCKS = 512, 64
ATSC_RATIO = 2.5                     # benchmarks/atsc_bench.py
ATSC_FS = 10.762238e6 * ATSC_RATIO
ATSC_IF = 0.26
ATSC_PACKETS = int(312 * 3.3)
ATSC_TIMED_RUNS = 5                  # after one warm-up run
DFE_TOL = 1e-4
DFE_TWIN_CHUNK = 4096                # most symbols a replayed twin step
PHASE11_LIMIT_S = 120.0
# the first design of each recursion kernel (one block a row and a block
# max a step; a 192-term warp dot a step), in ms on an NVIDIA H100 80GB
# HBM3 at 700 W, each a single call with its host side (median_ms): printed
# as "was" beside the new one-call time, with the redesign's target
WAS_MS = {"bank": "0.4333-0.4924", "b1": "0.2796-0.3558",
          "path": "23.9513-24.2314", "dfe": "41.7449-41.7589"}
TARGET_MS = {"bank": 0.10, "b1": 0.08, "path": 6.0, "dfe": 12.0}


def against(key: str, ms: float) -> str:
    """A one-call time against the first design's and the target."""
    verdict = "hit" if ms <= TARGET_MS[key] else "missed"
    return f"was {WAS_MS[key]}, target {TARGET_MS[key]:g}: {verdict}"


def fp32_bound(nbytes: float, ops: float):
    """(ms, "bytes" or "operations") for ``nbytes`` moved and ``ops``
    float32 operations (a multiply-add two) at the card's 67 TFLOP/s
    outside the tensor cores."""
    return bound(ops, nbytes, "f32")


def viterbi_bound(b, t_len, fsm):
    """The metrics read and the decisions written once; one add and one
    compare a candidate edge, one subtract a state, per step."""
    deg = fsm.PS.shape[1]
    return fp32_bound(b * t_len * (fsm.O + 1) * 4,
                      b * t_len * fsm.S * (2 * deg + 1))


def dfe_bound(n, nfb):
    """ff read and y written once; a multiply-add (two operations) a
    feedback tap and ~6 operations of the slicer, per symbol."""
    return fp32_bound(8 * n, n * (2 * nfb + 6))


def run_trellis_bank(torch):
    """11a: trellis_bench.py's Viterbi bank (FSM4, B=4096, K=512) through
    the kernel's chosen (warp) route and its block route, each held
    torch.equal to the twin on the card; B=1 through the kernel and through
    parallel=True (torch ops), decisions equal."""
    from grtpu_torch.ops import cuda_trellis as ct
    from grtpu_torch.trellis import FSM, viterbi

    fsm4 = FSM.from_convolutional(1, 2, [[0b101, 0b111]])
    m = torch.from_numpy(np.random.RandomState(0).rand(
        TRELLIS_B, TRELLIS_K, fsm4.O).astype(np.float32)).cuda()
    tab = ct.tables(fsm4, "cuda")
    got = viterbi(fsm4, m)
    ref = ct.viterbi_ref(m, tab)
    torch.cuda.synchronize()
    equal = torch.equal(got, ref)
    block = ct.viterbi_fwd(m, tab, _route="block")
    equal = equal and torch.equal(block, ref)
    ms = median_ms(lambda: ct.viterbi_fwd(m, tab))
    b2b_ms = launch_ms(lambda: ct.viterbi_fwd(m, tab))
    block_ms = median_ms(lambda: ct.viterbi_fwd(m, tab, _route="block"))
    twin_ms = median_ms(lambda: ct.viterbi_ref(m, tab))
    bms, by = viterbi_bound(TRELLIS_B, TRELLIS_K, fsm4)
    print(f"11a viterbi bank FSM4 {TRELLIS_B}x{TRELLIS_K}: kernel "
          f"({ct.viterbi_route(fsm4.S, 2, fsm4.O)} route) one call {ms:.4f} "
          f"ms = {ms * 1e6 / TRELLIS_K:.1f} ns a dependent step "
          f"({TRELLIS_B * TRELLIS_K / ms / 1e3:.1f} Msymbols/s; "
          f"{against('bank', ms)}), back to back {b2b_ms:.4f} ms = "
          f"{b2b_ms * 1e6 / TRELLIS_K:.1f} ns a step, block route one call "
          f"{block_ms:.4f} ms, twin {twin_ms:.4f} ms, bound {bms:.4f} ms "
          f"({by}; chain of {TRELLIS_K} dependent steps), share "
          f"{bms / ms:.4f}; both routes torch.equal to the twin: {equal}",
          flush=True)
    if not equal:
        fail("viterbi_fwd disagrees with its twin on the trellis bank")
    one = m[:1].contiguous()
    seq = viterbi(fsm4, one)
    par = viterbi(fsm4, one, parallel=True)
    ms1 = median_ms(lambda: viterbi(fsm4, one))
    b2b1_ms = launch_ms(lambda: viterbi(fsm4, one))
    ms_par = median_ms(lambda: viterbi(fsm4, one, parallel=True))
    same = torch.equal(seq, par)
    b1, _ = viterbi_bound(1, TRELLIS_K, fsm4)
    print(f"11a viterbi B=1 K={TRELLIS_K}: kernel one call {ms1:.4f} ms = "
          f"{ms1 * 1e6 / TRELLIS_K:.1f} ns a dependent step "
          f"({against('b1', ms1)}), back to back {b2b1_ms:.4f} ms = "
          f"{b2b1_ms * 1e6 / TRELLIS_K:.1f} ns a step, "
          f"bound {b1:.6f} ms, share {b1 / ms1:.5f}; "
          f"parallel=True (torch ops) {ms_par:.4f} ms; same decisions: {same}",
          flush=True)
    if not same:
        fail("the sequential and log-depth Viterbi disagree at B=1")


def run_sccc(torch):
    """11b: SCCC (FSM4 outer, FSM_MSB inner, Interleaver.random(512, 666),
    8 iterations) over 1024 blocks of clean metrics: the decoded bits equal
    the bits sent."""
    from grtpu_torch.trellis import (FSM, Interleaver, calc_metric_cost,
                                     fsm_encode, sccc_decoder)

    fsm4 = FSM.from_convolutional(1, 2, [[0b101, 0b111]])
    msb = FSM(4, 4, 8, NS=[0, 1, 2, 3] * 4,
              OS=[0, 5, 3, 6, 4, 1, 7, 2, 7, 2, 4, 1, 3, 6, 0, 5])
    il = Interleaver.random(SCCC_K, seed=666)
    bits = torch.from_numpy(np.random.RandomState(1).randint(
        0, 2, (SCCC_B, SCCC_K))).cuda()
    _, mid = fsm_encode(fsm4, bits, 0)
    _, sym = fsm_encode(msb, mid[:, torch.from_numpy(il.INTER).long().cuda()],
                        0)
    table = torch.arange(8, dtype=torch.float32, device="cuda") - 3.5
    metrics = calc_metric_cost(table[sym.long()], table)
    dec = sccc_decoder(fsm4, msb, il, metrics, SCCC_IT)      # warm-up
    secs = median_ms(lambda: sccc_decoder(fsm4, msb, il, metrics,
                                          SCCC_IT)) / 1e3
    ok = torch.equal(dec.long(), bits)
    print(f"11b SCCC {SCCC_B}x{SCCC_K}, {SCCC_IT} iterations (torch ops): "
          f"{secs:.3f} s a call (median of 5), {SCCC_B * SCCC_K / secs / 1e6:.3f} Msymbols/s; "
          f"decoded bits equal to the bits sent: {ok}", flush=True)
    if not ok:
        fail("the SCCC decoder did not return the bits sent")


def run_trellis_graph(torch, cf):
    """11c: TrellisEncoder -> symbols -> TrellisMetrics -> ViterbiDecoder
    through StreamExecutor, eager and under device_loop: outputs
    torch.equal across the modes and equal to the bits; viterbi_fwd
    launched in both (under device_loop counted at each replay)."""
    from grtpu_torch import Graph, Port, StreamExecutor
    from grtpu_torch.blocks.gengen import ChunksToSymbols
    from grtpu_torch.trellis import (FSM, TrellisEncoder, TrellisMetrics,
                                     ViterbiDecoder)

    fsm4 = FSM.from_convolutional(1, 2, [[0b101, 0b111]])
    k = TRELLIS_GRAPH_K
    bits = np.random.default_rng(2).integers(
        0, 2, TRELLIS_GRAPH_BLOCKS * k).astype(np.int32)
    bits.reshape(-1, k)[:, -2:] = 0          # each block ends in state 0
    pam = np.array([-1.5, -0.5, 0.5, 1.5], np.float32)

    def build():
        g = Graph()
        i = g.add_input(Port(torch.int32))
        o = g.add_output(Port(torch.int32))
        g.connect(i, TrellisEncoder(fsm4),
                  ChunksToSymbols(pam, torch.int32, torch.float32),
                  TrellisMetrics(4, 1, pam), ViterbiDecoder(fsm4, k, 0, 0), o)
        return StreamExecutor(g, chunk_size=4 * k, device="cuda")

    x = torch.from_numpy(bits).cuda()
    for name in cf.launches:
        cf.launches[name] = 0
    build().run(x)
    torch.cuda.synchronize()
    eager_launches = cf.launches["viterbi_fwd"]
    outs, _, _, loop_launches = two_modes(
        torch, "11c trellis graph", build, (x,), len(bits),
        unit="Msymbols/s", cf=cf)
    ok = np.array_equal(outs[-1].cpu().numpy(), bits)
    counts = [c["viterbi_fwd"] for c in loop_launches]
    print(f"11c viterbi_fwd launches: eager {eager_launches}, each "
          f"device_loop run {counts}; output equal to the bits: {ok}",
          flush=True)
    if not ok:
        fail("the trellis graph did not return its input bits")
    if eager_launches <= 0 or min(counts) <= 0:
        fail("viterbi_fwd was not launched in both executor modes")


def atsc_passband(torch):
    """atsc_bench.py's stream: 1029 packets from default_rng(7) ->
    AtscTransmitter -> AtscFieldSyncMux -> +1.25 pilot -> 201-tap RRC x5,
    every 2nd sample -> vsb_modulate (IF 0.26 fs, 2.5 samples a symbol)."""
    from grtpu_torch.models import atsc_rf as rf
    from grtpu_torch.models.atsc import AtscTransmitter
    from grtpu_torch.ops.fir import interp_fir_filter
    from grtpu_torch.utils import firdes

    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, (ATSC_PACKETS, 187)).astype(np.uint8)
    pkts = np.concatenate(
        [np.full((ATSC_PACKETS, 1), 0x47, np.uint8), payload], axis=1)
    levels = AtscTransmitter().process(pkts)
    codes = ((levels + 7) // 2).astype(np.uint8)
    nseg = len(codes) // 828
    stream = rf.AtscFieldSyncMux()(codes[: nseg * 828].reshape(nseg, 828))
    sym = stream.astype(np.float32) * 2 - 7 + 1.25
    rrc5 = firdes.root_raised_cosine(5.0, 5.0, 1.0, 0.115, 201).astype(
        np.float32)
    up5 = interp_fir_filter(torch.cat([torch.zeros(40, device="cuda"),
                                       torch.from_numpy(sym).cuda()]),
                            rrc5, 5).cpu().numpy()
    passband = rf.vsb_modulate(up5[::2].astype(np.float64), ATSC_IF,
                               ATSC_RATIO)
    return pkts, passband, nseg


def atsc_stages(rf, atsc):
    """The stages of config #5 whose times 11d prints: (name, owner,
    attribute, clock).  The receivers' own functions are wrapped, so a
    stage is exactly one call on the path; "host" marks a stage that ends
    in a read of the card or runs on the host, the rest are timed with
    CUDA events."""
    return [("pb_rrc", rf.AtscRfReceiver, "_passband", "cuda"),
            ("fpll", rf, "fpll_chunked", "cuda"),
            ("lpf_dc", rf.AtscRfReceiver, "_baseband", "cuda"),
            ("btl", rf, "bit_timing_loop", "cuda"),
            ("fs_correlate", rf, "fs_correlate", "cuda"),
            ("eq_train", rf.AtscEqualizerDfe, "_adapt", "cuda"),
            ("eq_filter", rf, "_dfe_filter", "cuda"),
            ("viterbi12", atsc, "trellis_decode", "host"),
            ("transport", atsc.AtscReceiver, "_transport", "host")]


def wrapped(owner, attr, before, after):
    """Replace ``owner.attr`` by a function that calls ``before(args)``,
    the original, then ``after(token)``; returns the original."""
    fn = getattr(owner, attr)

    def call(*args, **kwargs):
        token = before(args)
        out = fn(*args, **kwargs)
        after(token)
        return out

    setattr(owner, attr, call)
    return fn


def stage_timer(torch, into, name, clock):
    """(before, after) that add one time in ms, or a pair of CUDA events,
    to ``into[name]``."""
    if clock == "host":
        return (lambda args: time.perf_counter(),
                lambda t0: into.setdefault(name, []).append(
                    (time.perf_counter() - t0) * 1e3))

    def before(args):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        return start

    def after(start):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        into.setdefault(name, []).append((start, end))
    return before, after


def stage_ms(timings) -> dict:
    """Milliseconds a stage, summed over its calls in one run."""
    out = {}
    for name, entries in timings.items():
        ms = 0.0
        for e in entries:
            if isinstance(e, tuple):
                e[1].synchronize()
                e = e[0].elapsed_time(e[1])
            ms += e
        out[name] = ms
    return out


def dfe_twin_replayed(torch, ff, wfb, ring):
    """dfe_feedback_ref over the whole of ``ff``, in equal chunks of at most
    DFE_TWIN_CHUNK symbols, each chunk's step loop replayed from one CUDA
    graph (StepGraph): the twin's own ops, without ~10 host launches a
    symbol (~50 s a field).  Returns (y, the final ring)."""
    from grtpu_torch.ops import cuda_trellis as ct
    from grtpu_torch.runtime.step_graph import StepGraph

    n = ff.shape[0]
    c = max(d for d in range(1, DFE_TWIN_CHUNK + 1) if n % d == 0)
    x, yc, r = ff.new_empty(c), ff.new_empty(c), ring.clone()
    y = torch.empty_like(ff)

    def step():
        out, r_out = ct.dfe_feedback_ref(x, wfb, r)
        yc.copy_(out)
        r.copy_(r_out)

    graph = StepGraph(step, ff.device)
    for i in range(0, n, c):
        x.copy_(ff[i:i + c])
        graph()
        y[i:i + c].copy_(yc)
    return y, r


def run_atsc(torch, cf):
    """11d: config #5 at atsc_bench.py's shape.  Gates: >= 2 fields, >= 312
    packets equal to ones sent, 0 uncorrectable; viterbi_fwd and
    dfe_feedback_fwd launched; each kernel held to its twin on the inputs
    of its last launch in the last timed run (the Viterbi torch.equal, the
    DFE feedback equal in decisions and within DFE_TOL).  Returns the two
    kernels' report rows."""
    from grtpu_torch.models import atsc, atsc_rf as rf
    from grtpu_torch.ops import cuda_trellis as ct

    (pkts, passband, nseg), build_s = timed(torch, lambda: atsc_passband(torch))
    print(f"11d ATSC stream: {len(passband)} samples, {nseg} data segments, "
          f"built in {build_s:.1f} s (host numpy, the RRC on the card)",
          flush=True)
    runs = []
    inputs = {}

    def keep(name):
        """Keep a copy of the arguments of the kernel's last launch."""
        return (lambda args: inputs.__setitem__(name, tuple(
            a.clone() if isinstance(a, torch.Tensor) else a for a in args)),
                lambda token: None)

    for run in range(1 + ATSC_TIMED_RUNS):
        timings = {}
        hooks = [(owner, attr, *stage_timer(torch, timings, name, clock))
                 for name, owner, attr, clock in atsc_stages(rf, atsc)]
        hooks += [(ct, name, *keep(name))
                  for name in ("viterbi_fwd", "dfe_feedback")]
        saved = [(owner, attr, wrapped(owner, attr, b, a))
                 for owner, attr, b, a in hooks]
        try:
            for name in cf.launches:
                cf.launches[name] = 0
            rx = rf.AtscRfReceiver(fs=ATSC_FS, if_freq=ATSC_IF * ATSC_FS,
                                   ratio=ATSC_RATIO, equalizer="lms2")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fields = rx.process(passband)
            got, bad = atsc.AtscReceiver().process(
                np.concatenate([f.reshape(-1) for f in fields]))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = dict(cf.launches)
        finally:
            for owner, attr, fn in reversed(saved):
                setattr(owner, attr, fn)
        runs.append((fields, got, bad, secs, stage_ms(timings), counts))
    fields, got, bad, _, _, counts = runs[-1]
    secs = float(np.median([r[3] for r in runs[1:]]))
    ms = {k: float(np.median([r[4][k] for r in runs[1:]])) for k in runs[-1][4]}
    print(f"11d end to end: first run {runs[0][3]:.2f} s (captures included), "
          f"median of the next {ATSC_TIMED_RUNS} {secs:.2f} s = "
          f"{len(passband) / secs / 1e6:.3f} Msamples/s of input "
          f"({', '.join(f'{r[3]:.2f}' for r in runs[1:])} s)", flush=True)
    sent = {p.tobytes() for p in pkts}
    match = sum(g.tobytes() in sent for g in got)
    print(f"11d config #5: {fields.shape[0]} fields, {len(got)} packets, "
          f"{match} equal to ones sent, {bad} uncorrectable (gates >= 2, "
          f">= 312, 0)", flush=True)
    print(f"11d stage ms (median of {ATSC_TIMED_RUNS} runs; host clock for "
          "viterbi12 and transport, CUDA events for the rest): "
          + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()), flush=True)
    print(f"phase 11 path launches (11d's last run): {counts}", flush=True)
    if fields.shape[0] < 2 or match < 312 or bad:
        fail("config #5 missed a gate of atsc_bench.py")
    if counts["viterbi_fwd"] <= 0 or counts["dfe_feedback_fwd"] <= 0:
        fail("config #5 did not launch viterbi_fwd and dfe_feedback_fwd")

    # the 12-phase decode as the path launched it: kernel against twin
    m, tab, *ends = inputs["viterbi_fwd"]
    vk = ct.viterbi_fwd(m, tab, *ends)
    vblock = ct.viterbi_fwd(m, tab, *ends, _route="block")
    vr, vr_s = timed(torch, lambda: ct.viterbi_ref(m, tab, *ends))
    v_equal = torch.equal(vk, vr) and torch.equal(vblock, vr)
    v_ms = median_ms(lambda: ct.viterbi_fwd(m, tab, *ends))
    v_b2b = launch_ms(lambda: ct.viterbi_fwd(m, tab, *ends), reps=4)
    vblock_ms = median_ms(lambda: ct.viterbi_fwd(m, tab, *ends,
                                                 _route="block"))
    b12, t12 = m.shape[:2]
    fsm = atsc.atsc_trellis_fsm()
    vb, vby = viterbi_bound(b12, t12, fsm)
    print(f"11d viterbi_fwd {b12}x{t12} (the path's call, "
          f"{fields.shape[0]} fields): kernel "
          f"({ct.viterbi_route(fsm.S, fsm.PS.shape[1], fsm.O)} route) "
          f"one call {v_ms:.4f} ms = {v_ms * 1e6 / t12:.1f} ns a dependent "
          f"step ({against('path', v_ms)}), back to back {v_b2b:.4f} ms, "
          f"block route one call {vblock_ms:.4f} ms = "
          f"{vblock_ms * 1e6 / t12:.1f} ns a step, twin {vr_s * 1e3:.1f} ms "
          f"(one run), bound {vb:.6f} ms ({vby}; chain of {t12} dependent "
          f"steps), share {vb / v_ms:.6f}; both routes torch.equal to the "
          f"twin: {v_equal}", flush=True)
    if not v_equal:
        fail("viterbi_fwd disagrees with its twin on the path's call")

    # the DFE feedback of the path's last field: kernel against twin
    ff, wfb, ring = inputs["dfe_feedback"]
    yk, rk = ct.dfe_feedback(ff, wfb, ring)
    (yr, rr), yr_s = timed(torch, lambda: dfe_twin_replayed(torch, ff, wfb,
                                                            ring))
    d_equal = (torch.equal(ct.slice8(yk), ct.slice8(yr))
               and torch.equal(rk, rr))
    err = (yk - yr).abs().max().item()
    d_ms = median_ms(lambda: ct.dfe_feedback(ff, wfb, ring))
    d_b2b = launch_ms(lambda: ct.dfe_feedback(ff, wfb, ring), reps=4)
    n_ff = ff.shape[0]
    db, dby = dfe_bound(n_ff, wfb.shape[0])
    print(f"11d dfe_feedback_fwd {n_ff} symbols (the path's last field): "
          f"kernel one call {d_ms:.4f} ms = {d_ms * 1e6 / n_ff:.1f} ns a "
          f"dependent step ({against('dfe', d_ms)}), back to back "
          f"{d_b2b:.4f} ms, twin {yr_s * 1e3:.1f} ms (one run, "
          f"its step loop replayed from CUDA graphs, captures included), "
          f"bound {db:.6f} ms ({dby}; chain of {n_ff} dependent steps), "
          f"share {db / d_ms:.6f}; decisions and final ring equal: "
          f"{d_equal}, max_abs_err {err:.3e} (tol {DFE_TOL:g})", flush=True)
    if not d_equal or not err <= DFE_TOL:
        fail("dfe_feedback_fwd disagrees with its twin")
    rows = {
        "viterbi_fwd": {
            "name": "viterbi_fwd", "route": "cuda",
            "source": "grtpu_torch/csrc/trellis_viterbi.cu",
            "replaces": "grtpu/trellis/algorithms.py:89 and :113 (lax.scan, "
                        "vmapped at grtpu/models/atsc.py:245; no Pallas "
                        "kernel)",
            "launches": counts["viterbi_fwd"], "max_abs_err": 0.0,
            "ms": v_ms, "plain_ms": vr_s * 1e3, "bound_ms": vb,
            "bound_by": vby, "library_ms": None},
        "dfe_feedback_fwd": {
            "name": "dfe_feedback_fwd", "route": "cuda",
            "source": "grtpu_torch/csrc/atsc_dfe.cu",
            "replaces": "grtpu/models/atsc_rf.py:596 (lax.scan; no Pallas "
                        "kernel)",
            "launches": counts["dfe_feedback_fwd"], "max_abs_err": err,
            "ms": d_ms, "plain_ms": yr_s * 1e3, "bound_ms": db,
            "bound_by": dby, "library_ms": None},
    }
    return rows


PHASE12_LIMIT_S = 150.0
VOC_CHANNELS = 64                    # benchmarks/vocoder_bench.py
GSM_NFRAMES = 50
CVSD_SAMPLES = 1 << 15
G721_SAMPLES = 1 << 14
UNROLLS = (16, 32, 64)
UNROLL_PROBE = 1024                  # samples a channel of the U sweep
CPU_PREFIX = 256                     # samples a channel run again on the CPU
VOICE_FRAMES = 10
HRPT_LEAD = 2000                     # PLL acquisition before the first sync
HRPT_CHUNK = 22180                   # an emission of 1,109 words
IQ_SAMPLES = 4096
BLOCK_CHUNK = 1000                   # ragged against CtcssSquelch's 1024
GOLD_PATH = REPO / "tests" / "data" / "vocoder_golden.npz"


def ops_a_step(torch, fn) -> int:
    """Kernel-launching ops the dispatcher sees in ``fn()`` (views and
    scalar wrappers left out)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    views = {"select", "slice", "unsqueeze", "view", "expand", "t",
             "transpose", "alias", "detach", "scalar_tensor", "unbind",
             "_unsafe_view", "squeeze", "as_strided", "lift_fresh",
             "reshape", "permute", "view_as_real", "view_as_complex",
             "empty", "unfold"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if str(func).split(".")[1] not in views:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def run_block_library(torch):
    """12a: misc, fftblk, oscope and selftest blocks on the card, each graph
    eager and under device_loop (torch.equal), and against the CPU."""
    from grtpu_torch import Graph, Port, StreamExecutor
    from grtpu_torch.blocks import fftblk, gengen, misc, oscope, selftest

    rng = np.random.RandomState(12)

    def chain(dev, blocks, in_ports, out_ports, chunk):
        g = Graph()
        ins = [g.add_input(p) for p in in_ports]
        outs = [g.add_output(p) for p in out_ports]
        blk = blocks()
        for i, pin in enumerate(ins):
            g.connect(pin, (blk, i))
        for i, pout in enumerate(outs):
            g.connect((blk, i), pout)
        return StreamExecutor(g, chunk_size=chunk, device=dev)

    def check(label, blocks, in_ports, out_ports, xs, tol, chunk=BLOCK_CHUNK,
              db=False):
        dev_xs = [torch.from_numpy(x).cuda() for x in xs]
        eager, _, _, _ = two_modes(
            torch, f"12a {label}",
            lambda: chain("cuda", blocks, in_ports, out_ports, chunk),
            dev_xs, len(xs[0]), runs=1)
        cpu = chain("cpu", blocks, in_ports, out_ports, chunk).run(
            *[torch.from_numpy(x) for x in xs])
        got = eager[-1] if isinstance(eager[-1], tuple) else (eager[-1],)
        ref = cpu if isinstance(cpu, tuple) else (cpu,)

        def diff(a, b):
            a, b = a.cpu(), b.cpu()
            if not a.is_complex():
                a, b = a.double(), b.double()
            if db:      # in power against the peak: empty bins are rounding
                a, b = 10 ** (a / 10), 10 ** (b / 10)
                a, b = a / b.max(), b / b.max()
            return float((a - b).abs().max())

        err = max(diff(a, b) for a, b in zip(got, ref))
        print(f"12a {label}: card vs CPU max_abs_err={err:.3g}"
              f"{' in power / peak' if db else ''} (tol {tol:g})", flush=True)
        if not err <= tol:
            fail(f"12a {label}: card vs CPU {err} > {tol}")
        return got

    f32, c64, u8 = (Port(torch.float32), Port(torch.complex64),
                    Port(torch.uint8))
    # LogPwrFft 1024 on a tone at its bin
    fs, nfft, tone_bin = 1.024e6, 1024, 100
    tone = np.exp(2j * np.pi * tone_bin / nfft * np.arange(1 << 16)
                  ).astype(np.complex64)
    spec = check("LogPwrFft 1024", lambda: fftblk.LogPwrFft(
        fs, nfft, frame_rate=fs / nfft), [c64],
        [Port(torch.float32, nfft)], [tone], 1e-6, chunk=8192, db=True)[0]
    peak = spec.argmax(1).cpu().numpy()
    print(f"12a LogPwrFft: {spec.shape[0]} spectra, peak bin {set(peak)} "
          f"(tone at {nfft // 2 + tone_bin})", flush=True)
    if set(peak) != {nfft // 2 + tone_bin}:
        fail("12a LogPwrFft: the tone is not at its bin")
    # CtcssSquelch at a ragged chunk
    t = np.arange(8192) / 8000.0
    audio = (np.sin(2 * np.pi * 440 * t) + 0.15 * np.sin(2 * np.pi * 100 * t)
             * ((np.arange(8192) // 3000) % 2 == 0)).astype(np.float32)
    check("CtcssSquelch block 1024", lambda: misc.CtcssSquelch(
        8000.0, 100.0, 0.005, 1024), [f32], [f32], [audio], 1e-6)
    check("Threshold", lambda: misc.Threshold(-0.3, 0.3), [f32], [f32],
          [rng.randn(8192).astype(np.float32)], 0.0)
    pulses = np.zeros(IQ_SAMPLES, np.uint8)
    pulses[np.cumsum(7 + rng.randint(-1, 2, IQ_SAMPLES // 7))
           [:IQ_SAMPLES // 8]] = 1
    check("DpllBB", lambda: misc.DpllBB(7.3, 0.2), [u8], [u8], [pulses], 0.0)
    iq = (rng.randn(IQ_SAMPLES) + 1j * rng.randn(IQ_SAMPLES)
          ).astype(np.complex64)
    check("IqComp", lambda: misc.IqComp(0.01), [c64], [c64], [iq], 1e-5)
    check("Selector 2x2", lambda: misc.Selector(torch.float32, 2, 2, 1, 0),
          [f32, f32], [f32, f32], [rng.randn(4096).astype(np.float32),
                                   rng.randn(4096).astype(np.float32)], 0.0)
    check("Valve open", lambda: misc.Valve(torch.float32, open=True), [f32],
          [f32], [rng.randn(4096).astype(np.float32)], 0.0)

    # BurstTagger with its tags, both modes and the CPU
    n = 8192
    mag = np.zeros(n, np.float32)
    for a in rng.randint(0, n - 400, 6):
        mag[a:a + rng.randint(20, 300)] = 1.0
    sig = (np.arange(n) + 1j).astype(np.complex64)
    want = np.flatnonzero(np.diff(np.concatenate([[0.0], mag])) != 0)
    tags = {}
    for mode, dev in (("eager", "cuda"), ("device_loop", "cuda"),
                      ("cpu", "cpu")):
        g = Graph()
        ps, pm = g.add_input(c64), g.add_input(f32)
        bt = misc.BurstTagger(0.5)
        sink = gengen.VectorSink(torch.complex64, name="bursts")
        g.connect(ps, (bt, 0))
        g.connect(pm, (bt, 1))
        g.connect(bt, sink)
        ex = StreamExecutor(g, chunk_size=BLOCK_CHUNK, device=dev)
        ex.run(torch.from_numpy(sig).to(dev), torch.from_numpy(mag).to(dev),
               device_loop=mode == "device_loop")
        tags[mode] = sorted((t.offset, t.key, t.value)
                            for t in ex.sink_tags.get("bursts", []))
    same = tags["eager"] == tags["device_loop"] == tags["cpu"]
    print(f"12a BurstTagger: {len(tags['eager'])} tags, eager == device_loop "
          f"== CPU: {same}; offsets at the transitions: "
          f"{[o for o, _, _ in tags['eager']] == list(want)}", flush=True)
    if not same or [o for o, _, _ in tags["eager"]] != list(want):
        fail("12a BurstTagger tags")

    # Lfsr32kSource -> CheckLfsr32k, both modes; OscopeSink frames
    for mode in ("eager", "device_loop"):
        g = Graph()
        src, chk = selftest.Lfsr32kSource(), selftest.CheckLfsr32k()
        g.connect(src, chk)
        StreamExecutor(g, chunk_size=BLOCK_CHUNK, device="cuda").run(
            steps=16, device_loop=mode == "device_loop")
        rep = chk.report()
        print(f"12a Lfsr32kSource -> CheckLfsr32k ({mode}): {rep}",
              flush=True)
        if not rep["nright"] == rep["ntotal"] == 16 * BLOCK_CHUNK:
            fail("12a CheckLfsr32k did not lock")
    g = Graph()
    pin = g.add_input(f32)
    scope = oscope.OscopeSink(frame_size=128)
    g.connect(pin, scope)
    wave = np.sin(2 * np.pi * 200 * np.arange(8192) / 8000.0).astype(
        np.float32)
    StreamExecutor(g, chunk_size=BLOCK_CHUNK, device="cuda").run(
        torch.from_numpy(wave).cuda(), device_loop=True)
    print(f"12a OscopeSink: {len(scope.frames())} triggered frames",
          flush=True)
    if len(scope.frames()) < 4:
        fail("12a OscopeSink found no frames")


def bank_line(torch, label, secs, nsamp, steps, real_hz, ops, unroll,
              stats):
    msps = nsamp / secs / 1e6
    print(f"12b {label}: {secs * 1e3:.1f} ms = {msps:.4f} Msamples/s = "
          f"{msps * 1e6 / real_hz:.1f} real-time {real_hz / 1e3:g} kS/s "
          f"channels; {secs / steps * 1e6:.1f} us a step, {ops} ops a step, "
          f"{ops * unroll} nodes a replay (U={unroll}), "
          f"{stats['graphs']} graphs captured in "
          f"{stats['capture_seconds']:.3f} s, {stats['replays']} replays",
          flush=True)


def scan_run(torch, fn):
    """(result, seconds, scan_stats of the call)."""
    from grtpu_torch.runtime import step_graph

    for k in step_graph.scan_stats:
        step_graph.scan_stats[k] = 0
    y, secs = timed(torch, fn)
    return y, secs, dict(step_graph.scan_stats)


def run_vocoder_banks(torch):
    """12b: the vocoder banks at vocoder_bench.py's width."""
    from grtpu_torch.runtime import step_graph
    from grtpu_torch.vocoder import cvsd, g72x, gsm

    gold = np.load(GOLD_PATH)
    rng = np.random.RandomState(0)
    ch = VOC_CHANNELS

    def exact(label, got, want):
        same = bool(np.array_equal(got, want))
        print(f"12b {label}: {same}", flush=True)
        if not same:
            fail(f"12b {label}")

    # G.721: choose U on a prefix, then the whole bank
    pcm = (rng.randn(ch, G721_SAMPLES) * 3000).clip(-32768, 32767).astype(
        np.int16)
    pcm[0, :8000] = gold["input"]
    x = torch.from_numpy(pcm).cuda()
    best, default = None, step_graph.UNROLL
    for u in UNROLLS:
        step_graph.UNROLL = u
        st0 = g72x.g72x_init_state(channels=ch, device="cuda")
        _, secs, stats = scan_run(torch, lambda: g72x.g72x_encode(
            "g721", st0, x[:, :UNROLL_PROBE]))
        per = (secs - stats["capture_seconds"]) / UNROLL_PROBE * 1e6
        print(f"12b G.721 U={u}: {UNROLL_PROBE} steps in {secs * 1e3:.1f} "
              f"ms, capture {stats['capture_seconds'] * 1e3:.1f} ms, "
              f"{per:.1f} us a replayed step", flush=True)
        if best is None or per < best[1]:
            best = (u, per)
    u = step_graph.UNROLL = best[0]
    ops = ops_a_step(torch, lambda: g72x.g72x_encode(
        "g721", g72x.g72x_init_state(channels=ch, device="cuda"), x[:, :1]))
    st0 = g72x.g72x_init_state(channels=ch, device="cuda")
    (_, codes), secs, stats = scan_run(torch, lambda: g72x.g72x_encode(
        "g721", st0, x))
    bank_line(torch, f"G.721 encode {ch} x {G721_SAMPLES}", secs,
              ch * G721_SAMPLES, G721_SAMPLES, 8000.0, ops, u, stats)
    codes = codes.cpu()
    exact("G.721 channel 0 equal to the golden codes",
          codes[0, :8000].numpy(), gold["g721_codes"])
    _, cpu_codes = g72x.g72x_encode(
        "g721", g72x.g72x_init_state(channels=ch, device="cpu"),
        torch.from_numpy(pcm[:, :CPU_PREFIX]))
    exact(f"G.721 card equal to the CPU on {ch} x {CPU_PREFIX}",
          codes[:, :CPU_PREFIX].numpy(), cpu_codes.numpy())

    # CVSD encode
    p = cvsd._CvsdParams()
    pcm = (rng.randn(ch, CVSD_SAMPLES) * 3000).clip(-32768, 32767).astype(
        np.int16)
    x = torch.from_numpy(pcm).cuda()
    ops = ops_a_step(torch, lambda: cvsd.cvsd_encode_bits(
        p, cvsd.cvsd_init_state(p, channels=ch, device="cuda"), x[:, :1]))
    st0 = cvsd.cvsd_init_state(p, channels=ch, device="cuda")
    (_, bits), secs, stats = scan_run(
        torch, lambda: cvsd.cvsd_encode_bits(p, st0, x))
    bank_line(torch, f"CVSD encode {ch} x {CVSD_SAMPLES}", secs,
              ch * CVSD_SAMPLES, CVSD_SAMPLES, 64000.0, ops, u, stats)
    _, cpu_bits = cvsd.cvsd_encode_bits(
        p, cvsd.cvsd_init_state(p, channels=ch, device="cpu"),
        torch.from_numpy(pcm[:, :CPU_PREFIX]))
    exact(f"CVSD card equal to the CPU on {ch} x {CPU_PREFIX}",
          bits[:, :CPU_PREFIX].cpu().numpy(), cpu_bits.numpy())

    # GSM 06.10 encode and decode
    n = GSM_NFRAMES * 160
    pcm = (rng.randn(ch, n) * 3000).clip(-32768, 32767).astype(np.int16)
    pcm[0] = gold["input"]
    x = torch.from_numpy(pcm).cuda()
    ops_e = ops_a_step(torch, lambda: gsm.gsm_fr_encode(
        gsm.gsm_init_encode_state(channels=ch, device="cuda"), x[:, :160]))
    st0 = gsm.gsm_init_encode_state(channels=ch, device="cuda")
    (_, frames), secs_e, stats = scan_run(
        torch, lambda: gsm.gsm_fr_encode(st0, x))
    bank_line(torch, f"GSM encode {ch} x {GSM_NFRAMES} frames", secs_e,
              ch * n, GSM_NFRAMES, 8000.0, ops_e, 1, stats)
    ops_d = ops_a_step(torch, lambda: gsm.gsm_fr_decode(
        gsm.gsm_init_decode_state(channels=ch, device="cuda"),
        frames[:, :1]))
    dt0 = gsm.gsm_init_decode_state(channels=ch, device="cuda")
    (_, out), secs_d, stats = scan_run(
        torch, lambda: gsm.gsm_fr_decode(dt0, frames))
    bank_line(torch, f"GSM decode {ch} x {GSM_NFRAMES} frames", secs_d,
              ch * n, GSM_NFRAMES, 8000.0, ops_d, 1, stats)
    print(f"12b GSM encode + decode: "
          f"{ch * n / (secs_e + secs_d) / 1e6:.4f} Msamples/s = "
          f"{ch * n / (secs_e + secs_d) / 8000:.1f} real-time channels",
          flush=True)
    frames, out = frames.cpu(), out.cpu()
    exact("GSM channel 0 frames equal to the golden frames",
          frames[0].numpy().reshape(-1), gold["gsm_frames"])
    exact("GSM channel 0 decode equal to the golden decode",
          out[0].numpy(), gold["gsm_dec"])
    _, cpu_frames = gsm.gsm_fr_encode(
        gsm.gsm_init_encode_state(channels=ch, device="cpu"),
        torch.from_numpy(pcm[:, :320]))
    _, cpu_out = gsm.gsm_fr_decode(
        gsm.gsm_init_decode_state(channels=ch, device="cpu"), cpu_frames)
    exact(f"GSM card equal to the CPU on {ch} x 2 frames, both directions",
          np.concatenate([frames[:, :2].numpy().reshape(-1),
                          out[:, :320].numpy().reshape(-1).view(np.uint8)]),
          np.concatenate([cpu_frames.numpy().reshape(-1),
                          cpu_out.numpy().reshape(-1).view(np.uint8)]))
    step_graph.UNROLL = default
    return u


def run_codec2(torch):
    """12c: Codec2 on the host; device_loop refuses its blocks."""
    from grtpu_torch import Graph, Port, StreamExecutor
    from grtpu_torch.vocoder import codec2

    gold = np.load(GOLD_PATH)
    c2 = codec2.Codec2()
    t0 = time.perf_counter()
    bits = c2.encode(gold["input"])
    t1 = time.perf_counter()
    dec = codec2.Codec2().decode(bits).astype(np.int64)
    t2 = time.perf_counter()
    ref = gold["c2_dec"].astype(np.int64)
    snr = 10 * np.log10((ref ** 2).mean() / max(((dec - ref) ** 2).mean(),
                                                1e-12))
    exact_bits = bool(np.array_equal(np.asarray(bits, np.uint8),
                                     gold["c2_bits"]))
    print(f"12c Codec2 1 s on the host: encode {t1 - t0:.2f} s, decode "
          f"{t2 - t1:.2f} s ({1.0 / (t2 - t0):.1f}x real time); bits equal "
          f"to the golden: {exact_bits}; decode against the golden "
          f"{snr:.1f} dB (gate 50)", flush=True)
    if not exact_bits or snr <= 50.0:
        fail("12c Codec2 against the golden")

    def graph(dev):
        g = Graph()
        pin = g.add_input(Port(torch.int16))
        pout = g.add_output(Port(torch.uint8, 7))
        g.connect(pin, codec2.Codec2Encode(name="codec2enc"), pout)
        return StreamExecutor(g, chunk_size=1600, device=dev)

    x = torch.from_numpy(gold["input"].astype(np.int16)).cuda()
    try:
        graph("cuda").run(x, device_loop=True)
    except ValueError as e:
        print(f"12c device_loop over Codec2Encode refused: {e}", flush=True)
        if "codec2enc (Codec2Encode)" not in str(e):
            fail("12c the error does not name the block")
    else:
        fail("12c device_loop ran a graph holding Codec2Encode")
    frames = graph("cuda").run(x)
    same = bool(np.array_equal(frames.cpu().numpy().reshape(-1),
                               np.asarray(bits, np.uint8)))
    print(f"12c Codec2Encode eager on the card (through the host) equal to "
          f"Codec2.encode: {same}", flush=True)
    if not same:
        fail("12c Codec2Encode eager")


def run_digital_voice(torch):
    """12d: GSM over GMSK, end to end on the card, against the CPU."""
    from grtpu_torch.models.digital_voice import DigitalVoiceRx, DigitalVoiceTx

    print(f"12d cut: {VOICE_FRAMES} GSM frames of vocoder_bench.py's 50 (1 s "
          f"of audio): the GMSK receiver's M&M loop runs 32 symbols a "
          f"replay on the card (step_scan) and one at a time on the CPU",
          flush=True)
    t = np.arange(160 * VOICE_FRAMES)
    audio = (0.5 * np.sin(2 * np.pi * 300 / 8000 * t)
             + 0.2 * np.sin(2 * np.pi * 1100 / 8000 * t)).astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        iq = DigitalVoiceTx(device=dev)(audio)
        outs[dev] = DigitalVoiceRx(device=dev)(iq.cpu().numpy())
        secs = time.perf_counter() - t0
        if dev == "cuda":
            card_secs = secs
    n = min(len(outs["cuda"]), len(audio))
    a = audio[:n] - audio[:n].mean()
    b = outs["cuda"][:n] - outs["cuda"][:n].mean()
    corr = float(np.corrcoef(a[320:], b[320:])[0, 1])
    diff = float(np.abs(outs["cuda"] - outs["cpu"]).max()) \
        if outs["cuda"].shape == outs["cpu"].shape else float("inf")
    print(f"12d digital voice ({VOICE_FRAMES} GSM frames over GMSK, sps 8): "
          f"card {card_secs:.2f} s wall "
          f"({VOICE_FRAMES * 0.02 / card_secs:.3f}x real time); decoded "
          f"audio card vs CPU "
          f"max_abs_err={diff:.3g}, equal: {diff == 0.0}; correlation with "
          f"the source {corr:.3f} (gate 0.9)", flush=True)
    if corr <= 0.9:
        fail("12d digital voice did not carry the audio")


def run_noaa_and_pager(torch):
    """12e: two HRPT minor frames, HrptPll -> slicer -> HrptDeframer ->
    HrptDecoder in both modes; the FLEX numeric page through PagerSlicer."""
    from grtpu_torch import Graph, Port, StreamExecutor
    from grtpu_torch.digital.blocks import BinarySlicer
    from grtpu_torch.models import noaa, pager

    rng = np.random.RandomState(7)
    nw = noaa.HRPT_MINOR_FRAME_WORDS
    frames = []
    for mf in (1, 2):
        w = rng.randint(0, 1024, nw).astype(np.int64)
        w[:6] = noaa.HRPT_SYNC_WORDS
        w[6] = (mf << 7) | (13 << 3) | (w[6] & 0x7)
        frames.append(w)
    words = np.concatenate(frames)
    # biphase: bit b -> (~b, b); a lead of random biphase bits lets the PLL
    # and the deframer's mid-bit phase settle before the first sync word
    bits = np.concatenate([rng.randint(0, 2, HRPT_LEAD // 2).astype(np.uint8),
                           noaa.encode_words(words)])
    samples = np.empty(2 * len(bits) + 10, np.uint8)
    samples[0:-10:2], samples[1:-10:2], samples[-10:] = 1 - bits, bits, 0
    d = samples.astype(np.float64) * 2 - 1
    iq = np.exp(1j * (0.01 * np.arange(len(d)) + 0.7 * d)).astype(
        np.complex64)

    def build():
        g = Graph()
        pin = g.add_input(Port(torch.complex64))
        pout = g.add_output(Port(torch.int16))
        g.connect(pin, noaa.HrptPll(alpha=0.05), BinarySlicer(),
                  noaa.HrptDeframer(), pout)
        return StreamExecutor(g, chunk_size=HRPT_CHUNK, device="cuda")

    eager, rate, _, _ = two_modes(
        torch, f"12e HRPT {len(iq)} samples (HrptPll -> BinarySlicer -> "
        f"HrptDeframer)", build, [torch.from_numpy(iq).cuda()], len(iq),
        runs=1)
    got = eager[-1].cpu().numpy().astype(np.int64) & 0x3FF
    dec = noaa.HrptDecoder()
    dec.captured = (eager[-1],)
    rep = dec.report()
    same = bool(np.array_equal(got, words))
    print(f"12e HRPT: {len(got)} words, equal to the words sent: {same}; "
          f"frames_seen {rep['frames_seen']}, seq_errs {rep['seq_errs']}, "
          f"mfnums {rep['mfnums']}, spacecraft {rep['spacecraft']}",
          flush=True)
    if not same or rep["frames_seen"] != 2 or rep["seq_errs"] != 0:
        fail("12e HRPT frames")

    # the FLEX numeric page of tests/test_pager_misc.py:197-234
    msg = "555-8712"
    mwords = pager.pack_numeric(msg)
    viw = ((len(mwords) - 1) << 14) | (3 << 7) | \
        (pager.FLEX_STANDARD_NUMERIC << 4)
    fr = [0x1FFFFF] * 88
    fr[0], fr[1], fr[2] = 2 << 10, 20000 + 0x8000, viw
    for k, w in enumerate(mwords):
        fr[3 + k] = w
    coded = np.array([pager.flex_encode_word(w) for w in fr[:8]], np.uint64)
    fbits = np.concatenate([np.array(
        [(pager.FLEX_SYNC_1600 >> (31 - i)) & 1 for i in range(32)],
        np.uint8), pager.flex_interleave(coded)])
    g = Graph()
    pin = g.add_input(Port(torch.float32))
    pout = g.add_output(Port(torch.uint8))
    g.connect(pin, pager.PagerSlicer(), pout)
    sym = StreamExecutor(g, chunk_size=96, device="cuda").run(
        torch.from_numpy(fbits.astype(np.float32) * 2 - 1).cuda(),
        device_loop=True)
    rx = (sym.cpu().numpy() >> 1).astype(np.uint8)
    start = pager.find_sync(rx)
    infos = [pager.flex_decode_word(int(w))[0]
             for w in pager.flex_deinterleave(rx[start:start + 256])]
    pages = pager.parse_frame(infos + fr[8:]) if None not in infos else []
    print(f"12e FLEX numeric page through PagerSlicer (device_loop): sync at "
          f"{start}, pages {[p['content'] for p in pages]}", flush=True)
    if len(pages) != 1 or pages[0]["content"] != msg:
        fail("12e FLEX page")


# ------------------------- phase 13 (flowgraph files, host I/O, GUI, trace)
PHASE13_LIMIT_S = 120.0
AUDIO_RATE = int(CAPTURE_FS / TUNER_DECIM / AUDIO_DECIM)   # 32 kS/s
SERVICE_SAMPLES = 1 << 20     # 4 s at the quad rate
SERVICE_CHUNK = 4096
SERVICE_CREDITS = 2           # chunks the UDP sender may run ahead: a
                              # socket's receive buffer must hold them


def zero_launches(cf):
    for name in cf.launches:
        cf.launches[name] = 0


def clone_state(state):
    from grtpu_torch.runtime.executor import _leaves, _replace_leaves

    return _replace_leaves(state, {p: t.clone() for p, t in _leaves(state)})


def config1_spec(cap, wav, taps, impl="kernel"):
    """Phase 6a's chain as a flowgraph spec: capture file -> tuner -> WBFM
    (its audio FIR on ``impl``) -> WAV, chunk 524,288, the whole capture."""
    return {
        "options": {"id": "config1", "chunk_size": CAPTURE_CHUNK,
                    "steps": CAPTURE_SAMPLES // CAPTURE_CHUNK},
        "blocks": [
            {"id": "src", "key": "gr_file_source", "params": {"path": cap}},
            {"id": "tuner", "key": "gr_freq_xlating_fir_filter_xxx",
             "params": {"decimation": TUNER_DECIM,
                        "taps": [float(v) for v in taps],
                        "center_freq": TUNE_HZ, "sampling_freq": CAPTURE_FS}},
            {"id": "rcv", "key": "blks2_wfm_rcv",
             "params": {"quad_rate": QUAD_RATE,
                        "audio_decimation": AUDIO_DECIM, "impl": impl}},
            {"id": "wav", "key": "gr_wavfile_sink",
             "params": {"path": wav, "rate": AUDIO_RATE}}],
        "connections": [["src", 0, "tuner", 0], ["tuner", 0, "rcv", 0],
                        ["rcv", 0, "wav", 0]]}


def wav_pcm(path) -> np.ndarray:
    import wave

    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def run_spec_file(torch, cf, tmp, config1):
    """13a: config #1 from a JSON spec file, through the command line and
    in-process in both run modes."""
    import ast
    import json
    import os
    import re

    from grtpu_torch import StreamExecutor
    from grtpu_torch.grc import load_flowgraph
    from grtpu_torch.io.file import save_capture, save_wav

    cap, wav, spec_path = tmp / "capture.cfile", tmp / "audio.wav", \
        tmp / "config1.json"
    t0 = time.perf_counter()
    save_capture(str(cap), config1["capture"])
    spec_path.write_text(json.dumps(config1_spec(str(cap), str(wav),
                                                 config1["taps"])))
    print(f"13a spec: {spec_path.name}, capture file {cap.stat().st_size} "
          f"bytes written in {time.perf_counter() - t0:.2f} s", flush=True)
    nchunks = CAPTURE_SAMPLES // CAPTURE_CHUNK

    # as users run it: the command line, default device (the card)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "grtpu_torch.grc", "run",
                        str(spec_path)], capture_output=True, text=True,
                       cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
                       timeout=300)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"13a python -m grtpu_torch.grc run exited {r.returncode}:\n"
             f"{r.stdout}\n{r.stderr}")
    m = re.search(r"on (\S+): build ([\d.]+) s \(files read\), run ([\d.]+) "
                  r"s \((\d+) steps\), flush ([\d.]+) s; hand kernel "
                  r"launches (\{.*\})", r.stdout)
    if m is None:
        fail(f"13a: the command line printed no timing line:\n{r.stdout}")
    build_s, run_s, flush_s = (float(m.group(i)) for i in (2, 3, 5))
    cli_launches = ast.literal_eval(m.group(6))
    print(f"13a command line on {m.group(1)}: {CAPTURE_SAMPLES} input "
          f"samples, wall {wall:.3f} s = {CAPTURE_SAMPLES / wall / 1e6:.2f} "
          f"Msamples/s of input; of it process start and imports "
          f"{wall - build_s - run_s - flush_s:.3f} s, build with the file "
          f"read {build_s:.3f} s, run {run_s:.3f} s "
          f"({CAPTURE_SAMPLES / run_s / 1e6:.2f} Msamples/s, first run of a "
          f"fresh process), WAV write {flush_s:.3f} s; launches "
          f"{cli_launches}", flush=True)
    want = {"fir_decim_mma_fwd": nchunks, "iir1_fwd": nchunks}
    if cli_launches != want:
        fail(f"13a: the command line launched {cli_launches}; expected "
             f"{want} and nothing else")

    pcm = wav_pcm(wav)
    save_wav(str(tmp / "phase6a.wav"), AUDIO_RATE,
             config1["audio"]["kernel"])
    ref = wav_pcm(tmp / "phase6a.wav")
    lsb = int(np.abs(pcm.astype(np.int32) - ref).max()) if \
        pcm.shape == ref.shape else None
    snr = config1["snr"](pcm.astype(np.float32) / 32767.0)
    print(f"13a WAV: {pcm.shape[0]} samples at {AUDIO_RATE} S/s, SNR "
          f"{snr:.2f} dB (gate 30 dB), max |int16 - save_wav(phase 6a)| "
          f"{lsb} LSB (gate 1)", flush=True)
    if pcm.shape != ref.shape or lsb > 1:
        fail("13a: the WAV differs from phase 6a's audio by more than 1 LSB")
    if not snr > 30.0:
        fail(f"13a: WAV SNR {snr:.2f} dB <= 30 dB")

    # in-process: FlowgraphSpec.build + StreamExecutor, each mode in an
    # executor of its own, run twice (the first warms up and captures)
    outs = {}
    for mode in ("eager", "device_loop"):
        g, byid = load_flowgraph(str(spec_path)).build()
        ex = StreamExecutor(g, chunk_size=CAPTURE_CHUNK, device="cuda")
        state0 = clone_state(ex.state)
        ex.run(steps=nchunks, device_loop=mode == "device_loop")
        ex.state = clone_state(state0)
        zero_launches(cf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.run(steps=nchunks, device_loop=mode == "device_loop")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = {k: v for k, v in cf.launches.items() if v}
        outs[mode] = byid["wav"].captured[0]
        print(f"13a in-process {mode}: {CAPTURE_SAMPLES / secs / 1e6:.2f} "
              f"Msamples/s of input (second run, {secs:.3f} s); launches "
              f"{launched}", flush=True)
        if launched != want:
            fail(f"13a in-process {mode} launched {launched}; expected "
                 f"{want} and nothing else")
    same = torch.equal(outs["eager"], outs["device_loop"])
    inproc = np.clip(np.round(outs["eager"].cpu().numpy() * 32767.0),
                     -32768, 32767).astype(np.int16)
    print(f"13a device_loop torch.equal to eager: {same}; in-process PCM "
          f"equal to the command line's WAV: {np.array_equal(inproc, pcm)}",
          flush=True)
    if not same:
        fail("13a: the device_loop output differs from the eager output")


def grc_xml(path, blocks, connections):
    """A GRC 3.5 flow_graph file: blocks (key, {param: value}) with an ``id``
    param each; connections (src, src_port, dst, dst_port)."""
    from xml.sax.saxutils import escape

    out = ["<?xml version='1.0' encoding='ASCII'?>", "<flow_graph>"]
    for key, params in blocks:
        out.append(f"<block><key>{key}</key>" + "".join(
            f"<param><key>{k}</key><value>{escape(str(v))}</value></param>"
            for k, v in params.items()) + "</block>")
    for s, sp, d, dp in connections:
        out.append(f"<connection><source_block_id>{s}</source_block_id>"
                   f"<sink_block_id>{d}</sink_block_id><source_key>{sp}"
                   f"</source_key><sink_key>{dp}</sink_key></connection>")
    out.append("</flow_graph>")
    path.write_text("\n".join(out) + "\n")
    return str(path)


def run_grc_file(torch, cf, tmp, config1):
    """13b: the same chain as a .grc file through run_grc on the card."""
    from grtpu_torch.grc.grcxml import run_grc

    path = grc_xml(tmp / "config1.grc", [
        ("options", {"id": "config1"}),
        ("variable", {"id": "quad_rate", "value": "samp_rate / decim"}),
        ("variable", {"id": "samp_rate", "value": repr(CAPTURE_FS)}),
        ("variable", {"id": "decim", "value": str(TUNER_DECIM)}),
        ("gr_file_source", {"id": "src", "file": repr(str(tmp / "capture.cfile")),
                            "type": "complex", "repeat": "False"}),
        ("gr_freq_xlating_fir_filter_xxx", {
            "id": "tuner", "type": "ccc", "decim": "decim",
            "taps": "firdes.low_pass(1.0, samp_rate, 100e3, 50e3)",
            "center_freq": repr(TUNE_HZ), "samp_rate": "samp_rate"}),
        ("blks2_wfm_rcv", {"id": "rcv", "quad_rate": "quad_rate",
                           "audio_decimation": str(AUDIO_DECIM)}),
        ("virtual_sink", {"id": "vsink", "stream_id": "audio"}),
        ("virtual_source", {"id": "vsource", "stream_id": "audio"}),
        ("gr_vector_sink_x", {"id": "out", "type": "float", "vlen": "1"}),
        ("gr_null_sink", {"id": "unused", "type": "complex", "vlen": "1",
                          "_enabled": "False"})],
        [("src", 0, "tuner", 0), ("tuner", 0, "rcv", 0),
         ("rcv", 0, "vsink", 0), ("vsource", 0, "out", 0),
         ("tuner", 0, "unused", 0)])
    zero_launches(cf)
    t0 = time.perf_counter()
    ex, byid = run_grc(path, steps=CAPTURE_SAMPLES // CAPTURE_CHUNK,
                       chunk_size=CAPTURE_CHUNK, device="cuda")
    y = byid["out"].captured[0]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = dict(cf.launches)
    mxu = torch.from_numpy(config1["audio"]["mxu"]).to("cuda")
    err = (y - mxu).abs().max().item() if y.shape == mxu.shape else None
    print(f"13b .grc (2 variables in any order, firdes taps expression, a "
          f"virtual sink/source pair, a disabled block) on the card: "
          f"{CAPTURE_SAMPLES / secs / 1e6:.2f} Msamples/s of input with the "
          f"load (first run); audio filter impl "
          f"{byid['rcv'].audio_filter.impl}; max |audio - mxu chain| {err} "
          f"(tol 1e-5); kernel launches {launched}", flush=True)
    if err is None or not err <= 1e-5:
        fail("13b: the .grc chain disagrees with the in-memory mxu chain")
    nchunks = CAPTURE_SAMPLES // CAPTURE_CHUNK
    if {k: v for k, v in launched.items() if v} != {"iir1_fwd": nchunks}:
        fail(f"13b: the .grc path (impl auto -> mxu) launched {launched}; "
             f"expected the de-emphasis' iir1_fwd {nchunks} times and no "
             f"FIR kernel")


def service_signal(n, seed=13):
    """n complex64 samples of one WBFM station at the quad rate: a 1 kHz
    tone at 75 kHz deviation, with noise."""
    t = np.arange(n) / QUAD_RATE
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    x = np.exp(1j * np.cumsum(2 * np.pi * 75e3 / QUAD_RATE * msg))
    r = np.random.RandomState(seed)
    return (x + 0.01 * (r.randn(n) + 1j * r.randn(n))).astype(np.complex64)


def service_executor(torch):
    from grtpu_torch import StreamExecutor
    from grtpu_torch.models.fm import WfmRcv

    g = chain_graph(torch, [WfmRcv(QUAD_RATE, AUDIO_DECIM, impl="kernel")],
                    torch.complex64, [torch.float32])
    return StreamExecutor(g, chunk_size=SERVICE_CHUNK, device="cuda")


def run_service(torch, cf, tmp):
    """13c: the WBFM receiver as a service over localhost UDP, and fed from
    the native ring."""
    import socket
    import threading

    from grtpu_torch.io import native
    from grtpu_torch.io.udp import UdpSink, UdpSource

    x = service_signal(SERVICE_SAMPLES)
    nchunks = SERVICE_SAMPLES // SERVICE_CHUNK
    n_audio = SERVICE_SAMPLES // AUDIO_DECIM
    ref = service_executor(torch).run(torch.from_numpy(x).to("cuda"))
    torch.cuda.synchronize()

    # samples in over UDP -> stream() -> audio out over UDP
    src = UdpSource("127.0.0.1", 0, np.complex64, timeout=5.0)
    audio_rx = UdpSource("127.0.0.1", 0, np.float32, timeout=5.0)
    for sock in (src.sock, audio_rx.sock):
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
    rcvbuf = src.sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
    audio_tx = UdpSink("127.0.0.1", audio_rx.sock.getsockname()[1],
                       np.float32)
    iq_tx = UdpSink("127.0.0.1", src.sock.getsockname()[1], np.complex64)
    credits = threading.Semaphore(SERVICE_CREDITS)
    got = {}

    def send():
        for c in range(nchunks):
            credits.acquire()
            iq_tx.write_items(x[c * SERVICE_CHUNK:(c + 1) * SERVICE_CHUNK])
        iq_tx.close()

    def receive():
        got["audio"] = audio_rx.read_items(n_audio)

    def chunks():
        for arr in src.chunks(SERVICE_CHUNK):
            got["items"] = got.get("items", 0) + len(arr)
            credits.release()
            yield arr

    ex = service_executor(torch)
    ex.run(torch.from_numpy(x[:2 * SERVICE_CHUNK]).to("cuda"))  # warm-up
    ex = service_executor(torch)
    threads = [threading.Thread(target=send), threading.Thread(target=receive)]
    zero_launches(cf)
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for y in ex.stream(chunks()):
        audio_tx.write_items(y.cpu().numpy())
    audio_tx.close()
    for t in threads:
        t.join(timeout=30)
    secs = time.perf_counter() - t0
    launched = {k: v for k, v in cf.launches.items() if v}
    for sock in (src, audio_rx):
        sock.close()
    if any(t.is_alive() for t in threads):
        fail("13c: a UDP thread did not finish")
    audio = got.get("audio")
    equal = audio is not None and np.array_equal(audio, ref.cpu().numpy())
    print(f"13c UDP service: {got.get('items', 0)} of {SERVICE_SAMPLES} "
          f"samples in, {0 if audio is None else len(audio)} of {n_audio} "
          f"audio samples out, {SERVICE_SAMPLES / secs / 1e6:.2f} Msamples/s "
          f"of input (chunk {SERVICE_CHUNK}, sender {SERVICE_CREDITS} chunks "
          f"ahead at most, receive buffer {rcvbuf} bytes); audio equal to the in-memory run: {equal}; "
          f"launches {launched}", flush=True)
    if got.get("items") != SERVICE_SAMPLES or not equal:
        fail("13c: the UDP service lost items or changed the audio")
    if launched.get("fir_decim_mma_fwd") != nchunks:
        fail(f"13c: the UDP service launched {launched}")

    # capture file -> native ring (pump thread) -> stream()
    ok = native.available()
    print(f"13c native ring: available() {ok}, library "
          f"{native.library_path().relative_to(REPO)}", flush=True)
    if not ok:
        fail("13c: the native ring did not build (no host C++ compiler)")
    path = tmp / "service.cfile"
    x.tofile(path)
    ex = service_executor(torch)
    zero_launches(cf)
    t0 = time.perf_counter()
    src = native.NativeFileSource(str(path), np.complex64)
    y = torch.cat(list(ex.stream(src.chunks(SERVICE_CHUNK))))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    src.close()
    launched = {k: v for k, v in cf.launches.items() if v}
    same = torch.equal(y, ref)
    print(f"13c ring -> stream(): {SERVICE_SAMPLES / secs / 1e6:.2f} "
          f"Msamples/s of input; torch.equal to the in-memory run: {same}; "
          f"launches {launched}", flush=True)
    if not same:
        fail("13c: the ring path differs from the in-memory run")
    if launched.get("fir_decim_mma_fwd") != nchunks:
        fail(f"13c: the ring path launched {launched}")
    return ref


def run_gui_and_trace(torch, tmp, audio):
    """13d: the GUI sinks fed from the card against the CPU; the trace tools
    on the card."""
    from grtpu_torch import Graph, Port, StreamExecutor
    from grtpu_torch import gui
    from grtpu_torch.utils import trace

    x = service_signal(1 << 16, seed=14)
    a = audio[: 1 << 13].cpu().numpy()

    def sinks():
        return {"fft": gui.FftSink(1024, QUAD_RATE),
                "waterfall": gui.WaterfallSink(512, QUAD_RATE),
                "const": gui.ConstSink(4096),
                "scope": gui.ScopeSink(512, QUAD_RATE / AUDIO_DECIM),
                "number": gui.NumberSink(0.05),
                "histo": gui.HistoSinkDisplay(64)}

    def displays(device):
        s = sinks()
        for pad_dtype, keys, data in (
                (torch.complex64, ("fft", "waterfall", "const"), x),
                (torch.float32, ("scope", "number", "histo"), a)):
            g = Graph()
            pin = g.add_input(Port(pad_dtype))
            for k in keys:
                g.connect(pin, s[k])
            StreamExecutor(g, chunk_size=8192, device=device).run(data)
        return s, {"fft spectra": s["fft"].spectra(),
                   "fft spectrum": s["fft"].spectrum(),
                   "waterfall": s["waterfall"].spectra(),
                   "const": s["const"].points(),
                   "scope": np.stack(s["scope"].frames(0.0, "pos")),
                   "number": s["number"].trajectory(),
                   "histo": s["histo"].histogram()[0].astype(np.float64)}

    card, got = displays("cuda")
    _, want = displays("cpu")
    errs = {k: float(np.abs(got[k] - want[k]).max()) if got[k].shape ==
            want[k].shape else float("inf") for k in want}
    print(f"13d GUI sinks fed from the card, max |card - CPU| of each display "
          f"array (tol 1e-5): {errs}", flush=True)
    if not max(errs.values()) <= 1e-5:
        fail("13d: a GUI sink's display differs between the card and the CPU")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("13d GUI sinks: not rendered: no matplotlib", flush=True)
    else:
        sizes = {k: Path(s.render(str(tmp / f"{k}.png"))).stat().st_size
                 for k, s in card.items()}
        print(f"13d GUI sinks rendered, PNG bytes: {sizes}", flush=True)

    ex = service_executor(torch)
    tx = trace.TracedExecutor(ex)
    xs = torch.from_numpy(service_signal(8 * SERVICE_CHUNK, seed=15)).to(
        "cuda")
    for c in range(8):
        tx.step(xs[c * SERVICE_CHUNK:(c + 1) * SERVICE_CHUNK])
    print(f"13d TracedExecutor: {len(tx.lines)} lines for 8 steps; last: "
          f"{tx.lines[-1]}", flush=True)
    if len(tx.lines) != 8 or not all(
            line.startswith(f"step={i} wall_ms=")
            for i, line in enumerate(tx.lines)):
        fail("13d: TracedExecutor did not log one line a step")
    problems = trace.validate_state(ex)
    print(f"13d validate_state after 8 steps: {problems}", flush=True)
    if problems:
        fail("13d: validate_state found problems")
    timings = trace.block_timings(ex, iters=5)
    print("13d block_timings on the card (ms a chunk of "
          f"{SERVICE_CHUNK}, median of 5, CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in timings.items()), flush=True)
    if not all(v >= 0 for v in timings.values()):
        fail(f"13d: block_timings {timings}")
    with trace.profile(str(tmp / "profile")) as prof:
        for c in range(4):
            ex.step(xs[c * SERVICE_CHUNK:(c + 1) * SERVICE_CHUNK])
        torch.cuda.synchronize()
    files = list((tmp / "profile").glob("trace_*.json"))
    size = files[0].stat().st_size if files else 0
    kernels = sum(1 for e in prof.key_averages()
                  if getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0)) > 0)
    print(f"13d profile(): Chrome trace of 4 steps, {size} bytes, "
          f"{kernels} ops with device time", flush=True)
    if not size:
        fail("13d: profile() wrote no trace")


def run_phase13(torch, cf, config1):
    """Phase 13: config #1 from a spec file and a .grc file, the UDP and
    ring service, the GUI sinks and trace tools, on the card."""
    import tempfile

    zero_launches(cf)
    t13 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke13_") as d:
        tmp = Path(d)
        run_spec_file(torch, cf, tmp, config1)
        run_grc_file(torch, cf, tmp, config1)
        audio = run_service(torch, cf, tmp)
        run_gui_and_trace(torch, tmp, audio)
    secs = time.perf_counter() - t13
    print(f"phase 13 launches since 13c's ring path began (the ring's and "
          f"13d's): {dict(cf.launches)}; phase 13 took {secs:.1f} s (limit "
          f"{PHASE13_LIMIT_S:g} s)", flush=True)
    if secs > PHASE13_LIMIT_S:
        fail(f"phase 13 took {secs:.1f} s")


# --------------------------------------- phase 14 (the mesh executor layer)
PHASE14_LIMIT_S = 120.0
MESH_CHANNELS = 64              # benchmarks/wfm_bench.py:35-40: 64 channels of
MESH_SAMPLES = 1 << 18          # 2^18 complex samples at 256 kS/s, decimation 8
MESH_CHUNK = 65536
MESH_SHAPES = ((1, 1), (2, 2))  # (time, chan) meshes of logical shards
MESH_ATOL, MESH_RTOL = 2e-6, 1e-5   # grtpu's tests/test_mesh_executor.py
DRYRUN_ATOL = 1e-4              # __graft_entry__.py::_check_close
DRYRUN_SHARDS = 4               # 14c: the dryrun's sections on 4 shards
TSMM_SAMPLES = 1 << 20          # 14d: one stream of 2^20 samples, 4 spans
TSMM_SPANS = 4
TSMM_PREFIX = 4096              # 14d: symbols of the loop held against the CPU


def mesh_of(torch, shape):
    from grtpu_torch.runtime.mesh_executor import make_mesh

    n = shape[0] * shape[1]
    return make_mesh(n, ["cuda"] * n, time=shape[0])


def mesh_bank_iq(torch):
    """MESH_CHANNELS FM stations of MESH_SAMPLES samples at the quad rate,
    made on the card: channel c carries a 0.5-amplitude tone at 1000 + 50 c
    Hz (channel 0 is phase 4's tone) at 75 kHz deviation.  Returns (iq,
    channel 0's message)."""
    t = torch.arange(MESH_SAMPLES, dtype=torch.float64,
                     device="cuda") / QUAD_RATE
    f = 1000.0 + 50.0 * torch.arange(MESH_CHANNELS, dtype=torch.float64,
                                     device="cuda")
    msg = 0.5 * torch.sin(2 * np.pi * f[:, None] * t[None, :])
    phase = torch.cumsum(2 * np.pi * 75e3 / QUAD_RATE * msg, dim=1)
    iq = torch.polar(torch.ones_like(phase), phase).to(torch.complex64)
    return iq, msg[0].to(torch.float32).cpu().numpy()


def mesh_wbfm_graph(torch, impl):
    from grtpu_torch import Graph
    from grtpu_torch.runtime.block import Port
    from grtpu_torch.models.fm import WfmRcv

    g = Graph()
    pin = g.add_input(Port(torch.complex64))
    pout = g.add_output(Port(torch.float32))
    g.connect(pin, WfmRcv(QUAD_RATE, AUDIO_DECIM, impl=impl), pout)
    return g


def audio_snr(torch, msg, audio):
    """Recovered audio against the de-emphasized message (phase 4's
    measure)."""
    from grtpu_torch import Graph, StreamExecutor
    from grtpu_torch.runtime.block import Port
    from grtpu_torch.models.fm import FmDeemph

    g = Graph()
    p = g.add_input(Port(torch.float32))
    o = g.add_output(Port(torch.float32))
    g.connect(p, FmDeemph(QUAD_RATE / AUDIO_DECIM, 75e-6), o)
    ref = StreamExecutor(g, chunk_size=1024, device="cuda").run(
        msg[::AUDIO_DECIM]).cpu().numpy()
    settle = 512
    r, e = align(ref[settle:-settle], audio[settle:-settle])
    return snr_db(r.astype(np.float64), e.astype(np.float64))


def run_mesh_executor(torch, cf):
    """14a: the WBFM graph with its FIR on the kernel through MeshExecutor
    on (1,1) and (2,2) meshes of logical shards, eager and under
    device_loop, each run twice (the state carried); every channel against
    its own single-device StreamExecutor run twice; the kernel route
    against the same mesh on mxu.  Returns the launches of each mesh's
    second runs."""
    from grtpu_torch import StreamExecutor
    from grtpu_torch.runtime.mesh_executor import MeshExecutor

    nchan, nsamp, chunk = MESH_CHANNELS, MESH_SAMPLES, MESH_CHUNK
    iq, msg0 = mesh_bank_iq(torch)
    refs = []
    for c in range(nchan):
        ex = StreamExecutor(mesh_wbfm_graph(torch, "kernel"), chunk_size=chunk,
                            device="cuda")
        refs.append((ex.run(iq[c]), ex.run(iq[c])))
    ref = [torch.stack([r[k] for r in refs]) for k in (0, 1)]
    nchunks = nsamp // chunk
    outs, launches = {}, {}
    for shape in MESH_SHAPES:
        for mode in ("eager", "device_loop"):
            mex = MeshExecutor(mesh_wbfm_graph(torch, "kernel"),
                               mesh_of(torch, shape), nchan, chunk_size=chunk)
            loop = mode == "device_loop"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y1 = mex.run(iq, device_loop=loop)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            zero_launches(cf)
            t0 = time.perf_counter()
            y2 = mex.run(iq, device_loop=loop)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = dict(cf.launches)
            launches[(shape, mode)] = counts
            outs[(shape, mode)] = (y1, y2)
            print(f"14a MeshExecutor {shape} (time, chan) {mode}: "
                  f"{nchan * nsamp / secs / 1e6:.2f} Msamples/s of input "
                  f"({nchan} ch x {nsamp}, chunk {chunk}; second run "
                  f"{secs:.4f} s, first {first:.3f} s); route: {mex.route}; "
                  f"launches of the second run: {counts}", flush=True)
            want = nchan * shape[0] * nchunks
            if (counts["fir_decim_mma_fwd"] != want
                    or counts["iir1_fwd"] != want
                    or sum(counts.values()) != 2 * want):
                fail(f"14a {shape} {mode} launched {counts}; expected "
                     f"fir_decim_mma_fwd and iir1_fwd {want} times each and "
                     f"nothing else")
        for k in (0, 1):
            a, b = outs[(shape, "eager")][k], outs[(shape, "device_loop")][k]
            if not torch.equal(a, b):
                fail(f"14a {shape}: device_loop run {k + 1} differs from "
                     f"the eager run")
            if shape == (1, 1):
                if not torch.equal(a, ref[k]):
                    fail("14a (1,1): a channel differs from its single-device "
                         "executor")
            elif not torch.allclose(a, ref[k], atol=MESH_ATOL,
                                    rtol=MESH_RTOL):
                fail(f"14a {shape}: a channel is outside atol {MESH_ATOL}, "
                     f"rtol {MESH_RTOL} of its single-device executor")
        err = float((outs[(shape, "eager")][1] - ref[1]).abs().max())
        print(f"14a {shape}: eager torch.equal device_loop (both runs); max "
              f"|mesh - single-device| {err:.3e} "
              f"({'torch.equal' if shape == (1, 1) else 'gate atol 2e-6, rtol 1e-5'})",
              flush=True)
    # the kernel route against its twin in the sharded graph: the same
    # mesh with the FIR on the plain (mxu) route
    twin = MeshExecutor(mesh_wbfm_graph(torch, "mxu"),
                        mesh_of(torch, MESH_SHAPES[-1]), nchan,
                        chunk_size=chunk)
    twin.run(iq)
    plain = twin.run(iq)
    got = outs[(MESH_SHAPES[-1], "eager")][1]
    rel = float((got - plain).abs().max() / plain.abs().max())
    print(f"14a {MESH_SHAPES[-1]} kernel route vs mxu route: max_rel_err "
          f"{rel:.3e} (tol 1e-4)", flush=True)
    if not rel <= 1e-4:
        fail("14a: the mesh's kernel route disagrees with its mxu twin")
    snr = audio_snr(torch, msg0, outs[((1, 1), "eager")][0][0].cpu().numpy())
    print(f"14a channel 0 (phase 4's tone) audio SNR {snr:.2f} dB (gate 30 dB)",
          flush=True)
    if not snr > 30.0:
        fail(f"14a audio SNR {snr:.2f} dB <= 30 dB")
    from grtpu_torch.ops import fir
    from grtpu_torch.utils import firdes

    rate = QUAD_RATE / AUDIO_DECIM                # WfmRcv's audio taps
    k = firdes.low_pass(1.0, QUAD_RATE, rate / 2 - 1e3, rate / 10,
                        firdes.Window.HAMMING)
    for shape in MESH_SHAPES:
        n_loc = chunk // shape[0]
        x = torch.randn(n_loc + len(k) - 1, device="cuda")
        kern = median_ms(lambda: cf.fir_decim(x, k, AUDIO_DECIM), reps=20)
        mxu = median_ms(lambda: fir.fir_filter(x, k, AUDIO_DECIM), reps=20)
        print(f"14a route {shape}: fir_decim_mma_fwd one call on a "
              f"shard's {n_loc} samples {kern:.4f} ms (mxu route "
              f"{mxu:.4f} ms)", flush=True)
    return launches


def run_sharded_bank(torch):
    """14b: ShardedWfmBank over 64 x 2^18 steps on (2,2) against (1,1),
    each through jitted() (replayed from a CUDA graph on the card), the
    state carried over 3 steps: grtpu's test_parallel.py gates."""
    from grtpu_torch.parallel.mesh import Mesh
    from grtpu_torch.parallel.sharded_fm import ShardedWfmBank, make_mesh

    nchan, nsamp = MESH_CHANNELS, MESH_SAMPLES
    banks = {(1, 1): ShardedWfmBank(Mesh([["cuda"]], ("time", "chan")),
                                    nchannels=nchan),
             (2, 2): ShardedWfmBank(make_mesh(4, ["cuda"] * 4),
                                    nchannels=nchan)}
    fns = {s: b.jitted() for s, b in banks.items()}
    states = {s: b.init_state() for s, b in banks.items()}
    gen = torch.Generator(device="cuda").manual_seed(14)
    ms = {s: [] for s in banks}
    for step in range(3):
        iq = torch.complex(
            torch.randn(nchan, nsamp, generator=gen, device="cuda"),
            torch.randn(nchan, nsamp, generator=gen, device="cuda"))
        res = {}
        for s in banks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[s] = fns[s](iq, states[s])
            torch.cuda.synchronize()
            ms[s].append((time.perf_counter() - t0) * 1e3)
            states[s] = res[s][1]
        (a2, s2, p2), (a1, s1, p1) = res[(2, 2)], res[(1, 1)]
        da = float((a2 - a1).abs().max())
        ds = float((s2 - s1).abs().max())
        dp = abs(float(p2) - float(p1)) / abs(float(p1))
        print(f"14b step {step}: audio {tuple(a2.shape)}, (2,2) vs (1,1) max "
              f"|audio| diff {da:.3e} (tol 2e-4), power rel {dp:.3e} (tol "
              f"1e-3), state {ds:.3e} (tol 2e-4)", flush=True)
        if not (da <= 2e-4 and ds <= 2e-4 and dp <= 1e-3
                and torch.isfinite(a2).all()):
            fail(f"14b step {step}: the (2,2) bank left (1,1)'s bounds")
    for s in banks:
        print(f"14b ShardedWfmBank {s} jitted: ms a step {['%.3f' % v for v in ms[s]]} "
              f"(eager, captured, replayed); last "
              f"{nchan * nsamp / ms[s][-1] / 1e3:.2f} Msamples/s of input",
              flush=True)


def dryrun_close(torch, name, got, ref, atol=DRYRUN_ATOL):
    got = got if isinstance(got, torch.Tensor) else torch.as_tensor(got)
    ref = ref if isinstance(ref, torch.Tensor) else torch.as_tensor(ref)
    if got.shape != ref.shape:
        fail(f"14c {name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    err = float((got.to(ref.device) - ref).abs().max()) if got.numel() else 0.0
    print(f"14c {name}: matches single-device (max|diff|={err:.2e})",
          flush=True)
    if not err <= atol:
        fail(f"14c {name}: max|diff| {err:.2e} > {atol}")


def run_dryrun_sections(torch):
    """14c: __graft_entry__.py::dryrun_multichip's sections on a mesh of 4
    logical shards, at its own sizes, each against the single-device port
    executor."""
    from grtpu_torch import Graph, StreamExecutor
    from grtpu_torch.runtime.block import Port
    from grtpu_torch.parallel.mesh import Mesh
    from grtpu_torch.runtime.mesh_executor import MeshExecutor, make_mesh
    from grtpu_torch.models.fm import WfmRcv

    n_devices = DRYRUN_SHARDS
    mesh = make_mesh(n_devices, ["cuda"] * n_devices)
    cmesh = Mesh(np.array(["cuda"] * n_devices, dtype=object), ("chan",))
    r = np.random.RandomState(0)

    def single(g, chunk, **kw):
        return StreamExecutor(g, chunk_size=chunk, device="cuda", **kw)

    def wfm_graph():
        g = Graph()
        pin = g.add_input(Port(torch.complex64))
        pout = g.add_output(Port(torch.float32))
        g.connect(pin, WfmRcv(64e3, 4), pout)
        return g

    nchan = max(2 * mesh.shape["chan"], 2)
    chunk = 512 * mesh.shape["time"]
    iq = (r.randn(nchan, 2 * chunk)
          + 1j * r.randn(nchan, 2 * chunk)).astype(np.complex64)
    audio = MeshExecutor(wfm_graph(), mesh, nchan, chunk_size=chunk).run(iq)
    ref = torch.stack([single(wfm_graph(), chunk).run(iq[c])
                       for c in range(nchan)])
    dryrun_close(torch, f"WBFM Graph ({nchan}ch, time={mesh.shape['time']})",
                 audio, ref)

    from grtpu_torch.blocks.pfb import PfbChannelizer
    from grtpu_torch.blocks.stream import VectorToStreams
    from grtpu_torch.blocks.analog import QuadratureDemod

    nsub = 4

    def chan_graph():
        g = Graph()
        pin = g.add_input(Port(torch.complex64))
        ch = PfbChannelizer(nsub, taps_per_branch=8)
        v2s = VectorToStreams(torch.complex64, nsub)
        g.connect(pin, ch, v2s)
        for s in range(nsub):
            po = g.add_output(Port(torch.float32))
            g.connect((v2s, s), QuadratureDemod(1.0), po)
        return g

    nc = mesh.shape["chan"]
    iq2 = (r.randn(nc, chunk) + 1j * r.randn(nc, chunk)).astype(np.complex64)
    outs = MeshExecutor(chan_graph(), mesh, nc, chunk_size=chunk).run(iq2)
    refs = [single(chan_graph(), chunk).run(iq2[c]) for c in range(nc)]
    for s in range(nsub):
        dryrun_close(torch, f"channelizer sub {s}", outs[s],
                     torch.stack([rr[s] for rr in refs]))

    from grtpu_torch.digital.blocks import ClockRecoveryMMCC

    sps = 4

    def mm_graph():
        g = Graph()
        pin = g.add_input(Port(torch.complex64))
        pout = g.add_output(Port(torch.complex64))
        g.connect(pin, ClockRecoveryMMCC(sps, 0.25e-4, 0.5, 0.01), pout)
        return g

    syms = r.choice([-1.0, 1.0], size=(n_devices, 512 // sps + 8))
    sig = np.stack([np.repeat(s, sps)[:512] for s in syms]).astype(
        np.complex64)
    y3 = MeshExecutor(mm_graph(), cmesh, n_devices, chunk_size=512).run(sig)
    for c in range(n_devices):
        dryrun_close(torch, f"clock-recovery ch{c}", y3[c],
                     single(mm_graph(), 512).run(sig[c]))

    from grtpu_torch.blocks.analog import Agc2
    from grtpu_torch.blocks.pfb import PfbClockSync
    from grtpu_torch.digital.blocks import ConstellationReceiver, FllBandEdge
    from grtpu_torch.digital.constellation import psk_constellation
    from grtpu_torch.utils import firdes

    sps_d, ebw, nfilts = 4, 0.35, 32
    mf_bank = firdes.root_raised_cosine(
        nfilts, nfilts * sps_d, 1.0, ebw, 11 * sps_d * nfilts)

    def demod_graph():
        const = psk_constellation(4)
        const.points = (np.asarray(const.points)
                        * np.exp(1j * np.pi / 4)).astype(np.complex64)
        g = Graph()
        pin = g.add_input(Port(torch.complex64))
        pout = g.add_output(Port(torch.uint8))
        g.connect(pin,
                  Agc2(attack_rate=1e-1, decay_rate=1e-2, reference=1.0,
                       gain=1.0 / sps_d),
                  FllBandEdge(sps_d, ebw, sps_d * 4, 0.035),
                  PfbClockSync(sps_d, 0.045, mf_bank, nfilts=nfilts),
                  ConstellationReceiver(const, 0.06),
                  pout)
        return g

    rng = np.random.default_rng(7)
    nsym = 600
    rrc = firdes.root_raised_cosine(sps_d, sps_d, 1.0, ebw, 11 * sps_d)
    bursts = []
    for _ in range(n_devices):
        pts = (np.asarray(psk_constellation(4).points)
               * np.exp(1j * np.pi / 4))
        up = np.zeros(nsym * sps_d, np.complex64)
        up[::sps_d] = pts[rng.integers(0, 4, nsym)].astype(np.complex64)
        bursts.append(np.convolve(up, rrc)[: nsym * sps_d]
                      .astype(np.complex64))
    sig_d = np.stack(bursts)
    t0 = time.perf_counter()
    y4 = MeshExecutor(demod_graph(), cmesh, n_devices, chunk_size=800).run(
        sig_d)
    t_mesh = time.perf_counter() - t0
    for c in range(n_devices):
        dryrun_close(torch, f"generic demod chain ch{c}", y4[c].float(),
                     single(demod_graph(), 800).run(sig_d[c]).float())
    print(f"14c generic demod chain (PfbClockSync eager, no device_loop): the "
          f"mesh run took {t_mesh:.2f} s", flush=True)

    from grtpu_torch.digital.ofdm import OfdmFrameSink, OfdmModem, OfdmReceiver

    mdm = OfdmModem(fft_len=64, occupied=48, device="cuda")
    nsym_o = 4

    def ofdm_graph():
        rx = OfdmReceiver(mdm, nsym_data=nsym_o, sync_type="pn")
        g = Graph()
        pin = g.add_input(Port(torch.complex64))
        pb = g.add_output(Port(torch.uint8))
        pf = g.add_output(Port(torch.uint8))
        pc = g.add_output(Port(torch.complex64, mdm.occupied))
        g.connect(pin, rx)
        g.connect((rx, 0), OfdmFrameSink(mdm), pb)
        g.connect((rx, 1), pf)
        g.connect((rx, 2), pc)
        return g, rx

    span = (nsym_o + 2) * (mdm.fft_len + mdm.cp_len)
    streams = []
    for _ in range(n_devices):
        bits = rng.integers(0, 2, nsym_o * mdm.occupied * 2).astype(np.uint8)
        tx = mdm.modulate(bits)
        streams.append(np.concatenate(
            [np.zeros(100, np.complex64), tx,
             np.zeros(2 * span - len(tx) - 100 + span, np.complex64)]
        ).astype(np.complex64))
    sig_o = np.stack([s[: 3 * span] for s in streams])
    g_o, rx_o = ofdm_graph()
    outs5 = MeshExecutor(g_o, cmesh, n_devices, chunk_size=2 * span,
                         vr_chunks={rx_o: nsym_o}).run(sig_o)
    for c in range(n_devices):
        g_r, rx_r = ofdm_graph()
        refs5 = single(g_r, 2 * span, vr_chunks={rx_r: nsym_o}).run(sig_o[c])
        for j, label in enumerate(("bits", "flags", "chanest")):
            a, b = outs5[j][c], refs5[j]
            if not a.is_complex():
                a, b = a.float(), b.float()
            dryrun_close(torch, f"ofdm receiver ch{c} {label}", a, b)

    mex6 = MeshExecutor(wfm_graph(), mesh, nchan, chunk_size=chunk)
    dryrun_close(torch, "WBFM mesh device_loop",
                 mex6.run(iq, device_loop=True), ref)

    from grtpu_torch.ops.fir import fir_filter
    from grtpu_torch.parallel import mesh as pm
    from grtpu_torch.parallel.pipeline import fir_chain_pipeline, tap_parallel_fir

    r2 = np.random.RandomState(1)
    taps = r2.randn(n_devices, 9).astype(np.float32) / 9
    pmesh = Mesh(np.array(["cuda"] * n_devices, dtype=object), ("stage",))
    pipe = fir_chain_pipeline(pmesh, taps)
    xin = torch.from_numpy(r2.randn(4, 32).astype(np.float32))
    y = pipe.run(xin)
    seq = xin.ravel().to("cuda")
    for s in range(n_devices):
        seq = fir_filter(torch.cat([seq.new_zeros(8), seq]), taps[s], 1)
    dryrun_close(torch, f"{n_devices}-stage FIR pipeline (pp)", y.ravel(), seq)
    tmesh = Mesh(np.array(["cuda"] * n_devices, dtype=object), ("tp",))
    tl = r2.randn(n_devices, 8).astype(np.float32)
    xr = torch.from_numpy(r2.randn(256 + n_devices * 8 - 1).astype(np.float32))
    yt = tap_parallel_fir(xr, pm.shard(tl.reshape(-1), tmesh, pm.P("tp")),
                          tmesh, "tp")
    dryrun_close(torch, f"{n_devices}-way tap-parallel FIR (tp)", yt[(0,)],
                 fir_filter(xr.to("cuda"), tl.reshape(-1), 1), atol=3e-3)

    from grtpu_torch.trellis.fsm import FSM
    from grtpu_torch.trellis.interleaver import Interleaver
    from grtpu_torch.trellis.blocks import PcccDecoderCombined

    FSM4 = FSM.from_convolutional(1, 2, [[0b101, 0b111]])
    K_t = 64
    il_t = Interleaver.random(K_t, seed=5)
    pam = np.array([-3.0, -1.0, 1.0, 3.0], np.float32)
    tbl = np.stack(np.meshgrid(pam, pam, indexing="ij"),
                   axis=-1).reshape(-1).astype(np.float32)

    def pccc_graph():
        g = Graph()
        pin = g.add_input(Port(torch.float32))
        pout = g.add_output(Port(torch.int32))
        dec = PcccDecoderCombined(FSM4, 0, -1, FSM4, 0, -1, il_t, K_t,
                                  D=2, table=tbl, iterations=8,
                                  complex_in=False)
        g.connect(pin, dec, pout)
        return g

    rng_t = np.random.default_rng(11)
    obs, sent = [], []
    for _ in range(n_devices):
        bits = rng_t.integers(0, 2, K_t).astype(np.int64)
        o1 = FSM4.encode(bits)
        o2 = FSM4.encode(bits[il_t.INTER])
        pair = np.stack([pam[o1], pam[o2]], axis=-1).reshape(-1)
        obs.append(pair + 0.05 * rng_t.standard_normal(2 * K_t))
        sent.append(bits)
    obs = np.stack(obs).astype(np.float32)
    y7 = MeshExecutor(pccc_graph(), cmesh, n_devices,
                      chunk_size=2 * K_t).run(obs)
    for c in range(n_devices):
        ref7 = single(pccc_graph(), 2 * K_t).run(obs[c])
        dryrun_close(torch, f"pccc turbo bank ch{c}", y7[c].float(),
                     ref7.float())
        if not (y7[c].cpu().numpy() == sent[c]).all():
            fail(f"14c pccc turbo bank ch{c}: decoded bits differ from sent")

    from grtpu_torch.blocks.gengen import PackedToUnpacked
    from grtpu_torch.digital.packet_blocks import PacketDecoder, PacketEncoder

    plen = 64

    def pkt_graph():
        g = Graph()
        pin = g.add_input(Port(torch.float32))
        pout = g.add_output(Port(torch.float32))
        g.connect(pin, PacketEncoder(type="float", payload_length=plen),
                  PackedToUnpacked(1),
                  PacketDecoder(type="float", payload_length=plen), pout)
        return g

    items = plen // 4
    xp = r.randn(n_devices, 2 * items).astype(np.float32)
    y8 = MeshExecutor(pkt_graph(), cmesh, n_devices, chunk_size=items).run(xp)
    for c in range(n_devices):
        dryrun_close(torch, f"packet VR chain ch{c}", y8[c],
                     single(pkt_graph(), items).run(xp[c]))
        if not np.allclose(y8[c][:items].cpu().numpy(), xp[c, :items],
                           atol=1e-6):
            fail(f"14c packet chain ch{c}: the payload did not round-trip")

    import tempfile

    nchan_c, chunk_c = 4, 1024
    iqc = (r.randn(nchan_c, 4 * chunk_c)
           + 1j * r.randn(nchan_c, 4 * chunk_c)).astype(np.complex64)
    a = MeshExecutor(wfm_graph(), mesh_of(torch, (1, 2)), nchan_c,
                     chunk_size=chunk_c)
    a.run(iqc[:, :2 * chunk_c])
    with tempfile.TemporaryDirectory(prefix="chip_smoke14_") as td:
        ck = str(Path(td) / "mesh_ckpt.npz")
        a.save_checkpoint(ck)
        y_ref = a.run(iqc[:, 2 * chunk_c:])
        b = MeshExecutor(wfm_graph(), mesh_of(torch, (2, 2)), nchan_c,
                         chunk_size=chunk_c)
        b.load_checkpoint(ck)
        y_res = b.run(iqc[:, 2 * chunk_c:])
    dryrun_close(torch, "checkpoint (1,2) -> (2,2) mesh", y_res, y_ref)


def run_time_sharded_mm(torch):
    """14d: time_sharded_mm on 4 spans of one 2^20-sample stream (grtpu's
    test_parallel.py:329- shape and gains), against the continuous
    windowed loop on the card.  The spans and the continuous loop run the
    same recursion (loops.clock_recovery_mm_ff_windowed, a batch of 4 rows
    and of 1), so the agreement gate holds the splice; the recursion
    itself is held on the card against its eager CPU run (the first
    TSMM_PREFIX symbols, torch.equal), and against grtpu on the CPU by
    tests/test_torch_parallel.py."""
    from grtpu_torch.digital import loops
    from grtpu_torch.parallel.mesh import Mesh
    from grtpu_torch.parallel.timeshard_vr import time_sharded_mm

    rng = np.random.RandomState(0)
    sps, gm = 4, 0.175
    go = 0.25 * gm * gm
    syms = rng.choice([-1.0, 1.0], TSMM_SAMPLES // sps + 1)
    x = np.repeat(syms, sps).astype(np.float32)[2:TSMM_SAMPLES + 2]
    tmesh = Mesh(np.array(["cuda"] * TSMM_SPANS, dtype=object), ("time",))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_sh, diag = time_sharded_mm(x, sps, go, gm, nshards=TSMM_SPANS,
                                 overlap_syms=512, mesh=tmesh)
    t_sh = time.perf_counter() - t0
    W = 32
    L = sps + 2 * W + loops.NTAPS
    xp = torch.from_numpy(np.concatenate([np.zeros(W, np.float32), x,
                                          np.zeros(L + sps, np.float32)]))
    st = loops.mm_windowed_init_state(float(sps), 0.5, device="cuda")
    st = loops.MMWinState(*(f.reshape(1) for f in st))
    t0 = time.perf_counter()
    y_ref = loops.clock_recovery_mm_ff_windowed(
        xp[None].to("cuda"), st, sps, go, gm, W=W)[0][0].cpu()
    t_ref = time.perf_counter() - t0
    # the CPU's eager run of a prefix of the stream (each symbol reads
    # only the samples of its own window)
    n_pre = W + TSMM_PREFIX * sps + L
    y_cpu = loops.clock_recovery_mm_ff_windowed(
        xp[:n_pre], loops.mm_windowed_init_state(float(sps), 0.5,
                                                 device="cpu"),
        sps, go, gm, W=W)[0][:TSMM_PREFIX]
    same = torch.equal(y_ref[:TSMM_PREFIX], y_cpu)
    y_ref = y_ref.numpy()
    n = min(len(y_ref), len(y_sh)) - 8
    agree = float((np.sign(y_ref[200:n]) == np.sign(y_sh[200:n])).mean())
    print(f"14d time_sharded_mm: {len(x)} samples, {TSMM_SPANS} spans as one "
          f"batch {t_sh:.2f} s ({len(y_sh) / t_sh:.0f} symbols/s), the "
          f"continuous loop {t_ref:.2f} s; splice offsets {diag['offsets']}, "
          f"overlap agreement {['%.4f' % a for a in diag['agreement']]}; "
          f"kept symbols agreeing with the continuous loop {agree:.5f} "
          f"(gates 0.999); the loop's first {TSMM_PREFIX} symbols "
          f"torch.equal to the CPU's eager run: {same}", flush=True)
    if not (min(diag["agreement"]) > 0.999 and agree > 0.999):
        fail("14d: the time-sharded M&M parted from the continuous loop")
    if not same:
        fail("14d: the windowed M&M on the card differs from the CPU's run")


def run_phase14(torch, cf):
    """Phase 14: the mesh executor and the parallel package on the card."""
    t14 = time.perf_counter()
    launches = run_mesh_executor(torch, cf)
    run_sharded_bank(torch)
    run_dryrun_sections(torch)
    run_time_sharded_mm(torch)
    secs = time.perf_counter() - t14
    print(f"phase 14 path launches (each mesh's second run): "
          f"{ {f'{s} {m}': c['fir_decim_mma_fwd'] for (s, m), c in launches.items()} }"
          f" fir_decim_mma_fwd; phase 14 took {secs:.1f} s (limit "
          f"{PHASE14_LIMIT_S:g} s)", flush=True)
    if secs > PHASE14_LIMIT_S:
        fail(f"phase 14 took {secs:.1f} s")


# ------------------------------------ phase 15 (grtpu's examples, ported)
PHASE15_LIMIT_S = 150.0
TRELLIS_SCHEMES = ("tcm", "eq", "sccc", "pccc", "turbo-eq")
# trellis_ber's own defaults (K 1024, 32 packets, 10 iterations) at 10 dB
TRELLIS_ARGS = ["-K", "1024", "-r", "32", "-i", "10", "-e", "10"]
TRELLIS_CPU_REPS = "2"          # the turbo schemes are held to the CPU on 2
WFM_DEMOD_SAMPLES = 1 << 22     # phase 4's ~16 s of one station at 256 kS/s
EX_SERVICE_SAMPLES = 1 << 20    # stream_server's input at its default chunk
EX_SERVICE_CHUNK = 8192
EX_SERVICE_AHEAD = 2            # chunks the sender may run ahead of the audio
TXRX_PACKETS = 10               # benchmark_tx_rx's defaults: 10 packets of
                                # 64 bytes at 15 dB
OFDM_EXAMPLE_FRAMES = 4         # benchmark_ofdm's default
# digital_bert, cut from its default 4 chunks of 2^14 bits: its exact
# receive chain steps its loops one symbol at a time (117.7-232.8 symbols/s
# on an NVIDIA H100 80GB HBM3 at 700 W, phases 9b and 15f), so the default's
# 65,536 symbols would take 5-9 minutes and one chunk of 2^14 70-140 s of
# the phase's 150.  The chunk count and the bits a chunk are cut; the
# modulation (BPSK, M 2) and sps 4 are the example's.
BERT_ARGS = ["--snr", "10", "-n", "4096", "--chunks", "1"]
BERT_GATE = 0.05                # tests/test_apps.py's BER gate at 10 dB


def run_example(fn, args):
    """``fn(args)``, its printed lines captured; returns (lines, wall s).
    The examples print numbers read back from the card, so their wall time
    ends after the card's work."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        fn(args)
    return buf.getvalue().splitlines(), time.perf_counter() - t0


def with_option(args, flag, value):
    args = list(args)
    args[args.index(flag) + 1] = value
    return args


def deemphasized(torch, msg):
    """The reference of the WBFM audio: ``msg`` at the audio rate through
    the receiver's de-emphasis, on the card."""
    from grtpu_torch import StreamExecutor
    from grtpu_torch.models.fm import FmDeemph

    g = chain_graph(torch, [FmDeemph(QUAD_RATE / AUDIO_DECIM, 75e-6)],
                    torch.float32)
    return StreamExecutor(g, chunk_size=8192, device="cuda").run(
        msg[::AUDIO_DECIM]).cpu().numpy()


def run_trellis_examples(torch, cf):
    """15a: trellis_ber's five sweeps on the card at the example's sizes;
    tcm and eq held to the CPU's run of the same arguments, the turbo
    schemes on 2 packets."""
    from grtpu_torch.examples import trellis_ber

    for scheme in TRELLIS_SCHEMES:
        args = [scheme] + TRELLIS_ARGS
        zero_launches(cf)
        lines, secs = run_example(trellis_ber.main, args)
        launched = {k: v for k, v in cf.launches.items() if v}
        symbols = int(lines[-1].split("dB")[1].split("symbols")[0])
        print(f"15a trellis_ber {' '.join(args)}: {lines[-1]} | "
              f"{secs:.3f} s = {symbols / secs:.0f} symbols/s on the card; "
              f"hand kernel launches {launched}", flush=True)
        if scheme in ("tcm", "eq"):
            if not launched.get("viterbi_fwd"):
                fail(f"15a: trellis_ber {scheme} did not launch viterbi_fwd")
            card = lines
        else:
            args = with_option(args, "-r", TRELLIS_CPU_REPS)
            card, _ = run_example(trellis_ber.main, args)
        cpu, cpu_secs = run_example(trellis_ber.main, args + ["--device", "cpu"])
        same = card == cpu
        print(f"15a trellis_ber {' '.join(args)} on the CPU ({cpu_secs:.3f} "
              f"s): {cpu[-1]}; the card's counts equal: {same}", flush=True)
        if not same:
            fail(f"15a: trellis_ber {scheme} on the card {card} differs from "
                 f"the CPU {cpu}")


def run_wfm_demod_example(torch, cf, tmp):
    """15b: wfm_demod on phase 4's ~16 s of one station, from a .cfile."""
    from grtpu_torch.examples import wfm_demod
    from grtpu_torch.io.file import load_wav

    cap, wav = tmp / "station.cfile", tmp / "station.wav"
    service_signal(WFM_DEMOD_SAMPLES).tofile(cap)
    zero_launches(cf)
    lines, secs = run_example(wfm_demod.main, [str(cap), str(wav)])
    launched = {k: v for k, v in cf.launches.items() if v}
    rate, pcm = load_wav(str(wav))
    audio = pcm[:, 0].astype(np.float64)
    t = np.arange(WFM_DEMOD_SAMPLES) / QUAD_RATE
    ref = deemphasized(torch, (0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(
        np.float32)).astype(np.float64)
    settle = 512
    r, e = align(ref[settle:-settle], audio[settle:-settle])
    s = snr_db(r, e * (np.dot(r, e) / np.dot(e, e)))   # the WAV is scaled
    print(f"15b wfm_demod: {' | '.join(lines)} | {secs:.3f} s = "
          f"{WFM_DEMOD_SAMPLES / secs / 1e6:.2f} Msamples/s of input (file "
          f"read, WBFM, WAV written); WAV {rate} Hz, {len(audio)} samples, "
          f"SNR against the tone {s:.2f} dB (gate 30 dB); hand kernel "
          f"launches {launched} (WfmRcv impl auto: mxu)", flush=True)
    if rate != int(QUAD_RATE / AUDIO_DECIM) or \
            len(audio) != WFM_DEMOD_SAMPLES // AUDIO_DECIM or not s > 30.0:
        fail(f"15b: wfm_demod's WAV: {rate} Hz, {len(audio)} samples, "
             f"{s:.2f} dB")


def run_stream_server_example(torch, cf):
    """15c: stream_server's serve() on 2^20 samples over localhost UDP at
    its default chunk; the audio equal to an in-memory run of its graph."""
    import socket
    import threading

    from grtpu_torch import StreamExecutor
    from grtpu_torch.examples import stream_server
    from grtpu_torch.io import native
    from grtpu_torch.io.udp import UdpSink, UdpSource
    from grtpu_torch.models.fm import WfmRcv

    x = service_signal(EX_SERVICE_SAMPLES, seed=14)
    nchunks = EX_SERVICE_SAMPLES // EX_SERVICE_CHUNK
    per = EX_SERVICE_CHUNK // AUDIO_DECIM
    g = chain_graph(torch, [WfmRcv(QUAD_RATE, AUDIO_DECIM)], torch.complex64,
                    [torch.float32])
    ref = StreamExecutor(g, chunk_size=EX_SERVICE_CHUNK, device="cuda").run(
        torch.from_numpy(x).to("cuda")).cpu()
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    in_port = probe.getsockname()[1]
    probe.close()
    audio_rx = UdpSource("127.0.0.1", 0, np.float32, timeout=30.0)
    audio_rx.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
    ready, result = threading.Event(), {}
    credits = threading.Semaphore(EX_SERVICE_AHEAD)

    def server():
        result["counts"] = stream_server.serve(
            in_port, "127.0.0.1", audio_rx.sock.getsockname()[1],
            in_host="127.0.0.1", on_ready=ready.set)

    def send():
        tx = UdpSink("127.0.0.1", in_port, np.complex64)
        try:
            for c in range(nchunks):
                if not credits.acquire(timeout=30):
                    return
                tx.write_items(x[c * EX_SERVICE_CHUNK:
                                 (c + 1) * EX_SERVICE_CHUNK])
        finally:
            tx.close()          # the zero-length datagram ends the service

    threads = [threading.Thread(target=server), threading.Thread(target=send)]
    threads[0].start()
    if not ready.wait(timeout=120):
        fail("15c: the service never became ready")
    zero_launches(cf)
    t0 = time.perf_counter()
    threads[1].start()
    got = []
    for _ in range(nchunks):
        a = audio_rx.read_items(per)
        if a is None:
            break
        got.append(a)
        credits.release()
    for t in threads:
        t.join(timeout=60)
    secs = time.perf_counter() - t0
    audio_rx.close()
    launched = {k: v for k, v in cf.launches.items() if v}
    if any(t.is_alive() for t in threads):
        fail("15c: a thread of the service did not finish")
    audio = torch.from_numpy(np.concatenate(got)) if got else None
    equal = audio is not None and torch.equal(audio, ref)
    print(f"15c stream_server: served {result.get('counts')}, "
          f"{EX_SERVICE_SAMPLES / secs / 1e6:.2f} Msamples/s of input (chunk "
          f"{EX_SERVICE_CHUNK}, sender {EX_SERVICE_AHEAD} chunks ahead at "
          f"most, ingest on the native ring: {native.available()}); audio "
          f"torch.equal to the in-memory run: {equal}; hand kernel launches "
          f"{launched}", flush=True)
    if result.get("counts") != (EX_SERVICE_SAMPLES, EX_SERVICE_SAMPLES
                                // AUDIO_DECIM) or not equal:
        fail("15c: the service lost samples or changed the audio")


def run_tx_rx_examples(torch):
    """15d: benchmark_tx_rx's packet loop at its defaults, three modems."""
    from grtpu_torch.examples import benchmark_tx_rx

    for mod in ("gmsk", "dbpsk", "4fsk"):
        args = ["--modulation", mod]
        card, secs = run_example(benchmark_tx_rx.main, args)
        cpu, cpu_secs = run_example(benchmark_tx_rx.main,
                                    args + ["--device", "cpu"])
        intact = int(card[-1].split("/")[0])
        print(f"15d benchmark_tx_rx {mod}: {card[-1]} | {secs:.3f} s = "
              f"{TXRX_PACKETS / secs:.2f} packets/s on the card "
              f"({cpu_secs:.3f} s on the CPU); every line equal to the CPU "
              f"run's: {card == cpu}", flush=True)
        # grtpu's own example loses 4fsk's packet 9 at 15 dB: the 4FSK
        # gate is the CPU run, which the parity tests hold to grtpu's
        if card != cpu or (mod != "4fsk" and intact != TXRX_PACKETS):
            fail(f"15d: benchmark_tx_rx {mod}: {card} (CPU {cpu})")


def run_ofdm_examples(torch):
    """15e: benchmark_ofdm's frames, flat and multipath, and its curve."""
    from grtpu_torch.examples import benchmark_ofdm

    for label, args in (("flat", []), ("multipath", ["--multipath"])):
        lines, secs = run_example(benchmark_ofdm.main, args)
        ok = int(lines[-1].split("/")[0])
        print(f"15e benchmark_ofdm {label}: {lines[-1]} | {secs:.3f} s = "
              f"{OFDM_EXAMPLE_FRAMES / secs:.2f} frames/s", flush=True)
        for line in lines[:-2]:
            print(f"    {line}")
        if ok != OFDM_EXAMPLE_FRAMES:
            fail(f"15e: benchmark_ofdm {label}: {lines[-1]}")
    lines, secs = run_example(benchmark_ofdm.main, ["--curve"])
    points = [json.loads(line) for line in lines]
    frames = len(points) * OFDM_EXAMPLE_FRAMES * 2
    print(f"15e benchmark_ofdm --curve: {secs:.3f} s, {frames / secs:.2f} "
          f"frames/s (each frame through the burst modem and the streaming "
          f"graph)", flush=True)
    for p in points:
        print(f"    {json.dumps(p)}")
    bad = [p for p in points if p["frames_streaming"] != OFDM_EXAMPLE_FRAMES
           or (p["snr_db"] >= 16 and max(p["ber_burst"],
                                         p["ber_streaming"]) >= 0.02)]
    if len(points) != 5 or bad:
        fail(f"15e: benchmark_ofdm --curve: {bad or points}")


def run_bert_example(torch):
    """15f: digital_bert at 10 dB on the card and on the CPU (cut above)."""
    from grtpu_torch.examples import digital_bert

    card, secs = run_example(digital_bert.main, BERT_ARGS)
    cpu, cpu_secs = run_example(digital_bert.main, BERT_ARGS + ["--device",
                                                                "cpu"])
    nsym = int(BERT_ARGS[BERT_ARGS.index("-n") + 1]) * int(
        BERT_ARGS[BERT_ARGS.index("--chunks") + 1])
    ber, ber_cpu = (float(lines[-1].rsplit("BER:", 1)[1])
                    for lines in (card, cpu))
    print(f"15f digital_bert {' '.join(BERT_ARGS)} (cut from 4 chunks of "
          f"16384 bits): {card[-1]} | {secs:.3f} s = {nsym / secs:.1f} "
          f"symbols/s on the card; CPU ({cpu_secs:.3f} s = "
          f"{nsym / cpu_secs:.1f} symbols/s): {cpu[-1]}", flush=True)
    if not (ber < BERT_GATE and ber == ber_cpu):
        fail(f"15f: digital_bert BER {ber} (CPU {ber_cpu}, gate {BERT_GATE})")


def run_howto_example(torch):
    """15g: howto_write_a_block's QA on the card, and its tag block under
    run(device_loop=True) and on a 2-channel MeshExecutor."""
    from grtpu_torch import Graph, StreamExecutor
    from grtpu_torch.blocks.gengen import VectorSink
    from grtpu_torch.examples import howto_write_a_block as howto
    from grtpu_torch.runtime.block import Port
    from grtpu_torch.runtime.mesh_executor import MeshExecutor

    lines, secs = run_example(howto.main, [])
    print(f"15g howto_write_a_block ({secs:.3f} s): {' | '.join(lines)}",
          flush=True)
    if len(lines) != 3 or not all(": OK" in line for line in lines):
        fail(f"15g: howto_write_a_block's QA: {lines}")
    src = np.array([0, 2, 0, 0, 3, 3, 0, 2], np.float32)
    offsets = {}
    for mode in ("step", "device_loop", "mesh", "mesh device_loop"):
        g = Graph()
        pin = g.add_input(Port(torch.float32))
        s = VectorSink(dtype=torch.float32)
        g.connect(pin, howto.ThresholdTagFF(1.0), s)
        if mode.startswith("mesh"):
            ex = MeshExecutor(g, mesh_of(torch, (1, 2)), 2, chunk_size=4)
            ex.run(np.stack([src, src]), device_loop="device_loop" in mode)
            offsets[mode] = [sorted(t.offset for t in ex.sink_tags_chan(
                s.name, c)) for c in range(2)]
        else:
            ex = StreamExecutor(g, chunk_size=4, device="cuda")
            ex.run(src, device_loop=mode == "device_loop")
            offsets[mode] = [sorted(t.offset for t in ex.sink_tags[s.name])]
    print(f"15g ThresholdTagFF offsets (chunk 4): {offsets}", flush=True)
    if any(o != [1, 4, 7] for v in offsets.values() for o in v):
        fail(f"15g: tag offsets {offsets}")


def run_phase15(torch, cf):
    """Phase 15: grtpu's examples, ported, on the card."""
    import tempfile

    t15 = time.perf_counter()
    marks = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke15_") as d:
        for name, fn in (
                ("trellis_ber", lambda: run_trellis_examples(torch, cf)),
                ("wfm_demod", lambda: run_wfm_demod_example(torch, cf,
                                                            Path(d))),
                ("stream_server", lambda: run_stream_server_example(torch,
                                                                    cf)),
                ("benchmark_tx_rx", lambda: run_tx_rx_examples(torch)),
                ("benchmark_ofdm", lambda: run_ofdm_examples(torch)),
                ("digital_bert", lambda: run_bert_example(torch)),
                ("howto_write_a_block", lambda: run_howto_example(torch))):
            t0 = time.perf_counter()
            fn()
            marks[name] = round(time.perf_counter() - t0, 3)
    secs = time.perf_counter() - t15
    print(f"phase 15 wall s by example: {marks}; phase 15 took {secs:.1f} s "
          f"(limit {PHASE15_LIMIT_S:g} s)", flush=True)
    if secs > PHASE15_LIMIT_S:
        fail(f"phase 15 took {secs:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this check runs only on a GPU", file=sys.stderr)
        return 1
    if not (REPO / "grtpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: grtpu_torch not found beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))

    # phase 1: device and precision
    smi = gpu_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    from grtpu_torch.ops import _build, cuda_fir as cf, fir
    from grtpu_torch.utils import firdes

    cached = all(path.exists() for path in _build.library_paths())
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built: "
          f"{', '.join(path.name for path in _build.library_paths())} in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({'loaded from cache' if cached else 'nvcc ran'})", flush=True)

    # phase 3: each kernel against its twin
    rows, headline = check_kernels(torch, cf, fir, firdes, _build)
    iir1_row = run_iir1(torch, cf)
    iir1_held = hold_iir1(torch)
    mm_row = run_mm(torch, cf)

    # phase 4: the main path
    counts, rate = run_main_path(torch, cf, headline)

    # phase 5: the DMR slice; the stream's clock recovery must launch
    # mm_fwd, and nothing else is required
    for name in cf.launches:
        cf.launches[name] = 0
    run_dmr_bank(torch)
    run_dmr_stream(torch)
    dmr_launches = dict(cf.launches)
    print(f"DMR path launches: {dmr_launches}")
    if not dmr_launches["mm_fwd"]:
        fail("the DMR stream's clock recovery did not launch mm_fwd")

    # phase 6: config #1 in full (tuner -> WBFM) and the FM family; its own
    # launch counts, zeroed before and read after
    _, _, config1 = run_tuner_wbfm(torch, cf)
    run_tuner_kernel(torch, cf, config1["capture"])
    run_channel_select(torch, cf, config1["capture"])
    run_channel_select(torch, cf, config1["capture"], decim=1)
    run_fm_family(torch)

    # phase 7: config #2, the polyphase filterbank (no hand kernel)
    run_channelizer(torch)
    run_arb_resampler(torch)
    run_pfb_graphs(torch)
    run_sequential_loops(torch)

    # phase 8: the executor's own cost a chunk
    run_executor_overhead(torch)

    # phase 9: config #3, the digital loopback; it reaches no hand kernel,
    # so its launch counts are read and printed, not required
    for name in cf.launches:
        cf.launches[name] = 0
    run_psk_bank(torch)
    run_exact_forms(torch)
    run_loopback_graphs(torch)
    run_equalizers(torch)
    run_noise_resume(torch)
    print(f"config #3 path launches: {dict(cf.launches)}", flush=True)

    # phase 10: messages, stream tags, the packet layer and OFDM; they reach
    # no hand kernel (the correlator is a float32 matmul FIR, OFDM cuFFT)
    for name in cf.launches:
        cf.launches[name] = 0
    t10 = time.perf_counter()
    run_packets_and_tags(torch)
    for label, fft, occ, cp in OFDM_WIDTHS:
        run_ofdm_stream(torch, label, fft, occ, cp)
    run_ofdm_bank(torch)
    run_ofdm_packets(torch)
    launches10 = dict(cf.launches)
    print(f"phase 10 path launches: {launches10} (hand kernels launched: "
          f"{sum(launches10.values())}); phase 10 took "
          f"{time.perf_counter() - t10:.1f} s", flush=True)
    if sum(launches10.values()):
        fail("phase 10 reached a hand kernel")

    # phase 11: trellis, FEC and the ATSC 8-VSB receive chain (config #5);
    # its main path is 11d, whose launch counts it reports
    t11 = time.perf_counter()
    run_trellis_bank(torch)
    run_sccc(torch)
    run_trellis_graph(torch, cf)
    rows11 = run_atsc(torch, cf)
    secs11 = time.perf_counter() - t11
    print(f"phase 11 took {secs11:.1f} s (limit {PHASE11_LIMIT_S:g} s)",
          flush=True)
    if secs11 > PHASE11_LIMIT_S:
        fail(f"phase 11 took {secs11:.1f} s")

    # phase 12: the block library, the vocoders, digital voice, NOAA and the
    # pager; they reach no hand kernel, so the counts are read and printed
    from grtpu_torch.runtime import step_graph

    for name in cf.launches:
        cf.launches[name] = 0
    t12 = time.perf_counter()
    run_block_library(torch)
    unroll = run_vocoder_banks(torch)
    run_codec2(torch)
    run_digital_voice(torch)
    run_noaa_and_pager(torch)
    secs12 = time.perf_counter() - t12
    print(f"phase 12 path launches: {dict(cf.launches)}; the G.721 bank's "
          f"fastest U {unroll} (step_graph.UNROLL {step_graph.UNROLL}, used "
          f"by every other loop)", flush=True)
    print(f"phase 12 took {secs12:.1f} s (limit {PHASE12_LIMIT_S:g} s)",
          flush=True)
    if secs12 > PHASE12_LIMIT_S:
        fail(f"phase 12 took {secs12:.1f} s")

    # phase 13: config #1 from a flowgraph file and over UDP, host I/O, the
    # GUI sinks and the trace tools; launch counts zeroed before, read after
    run_phase13(torch, cf, config1)

    # phase 14: the mesh executor and the parallel package: config #1's
    # 64-channel bank over meshes of logical shards; launch counts zeroed
    # before each mesh run and read after it
    run_phase14(torch, cf)

    # phase 15: grtpu's examples, ported, each run through its main() (or
    # serve()) on the card as a user runs it
    run_phase15(torch, cf)

    # phase 16: report, for each kernel the case the main path launches most
    pick = {"fir_tile_fwd": ("fir_cascade 16x2^20 K4097", "f32"),
            "fir_toeplitz_fwd": ("fir_cascade 16x2^20 K4097 bf16in", "bf16"),
            "fir_decim_fwd": ("fir_decim 64x2^18 K155 d8", "f32"),
            "fir_decim_mma_fwd": ("fir_decim 1x65536 K193 d8", "bf16x3"),
            "fir_cascade_fwd": ("fir_cascade 16x2^20 S16 K256", "f32"),
            "fir_cascade_mma_fwd": ("fir_cascade 16x2^20 S16 K256", "bf16x3")}
    kernels = []
    for name, (case_name, prec) in pick.items():
        row = next(r for r in rows if r["case"] == case_name
                   and r["precision"] == prec and r["kernel"] == name)
        kernels.append({
            "name": name, "route": "cuda",
            "source": {"fir_decim_fwd": "grtpu_torch/csrc/fir_decim.cu",
                       "fir_decim_mma_fwd": "grtpu_torch/csrc/fir_decim_mma.cu"}
            .get(name, "grtpu_torch/csrc/fir_tile.cu"),
            "replaces": "grtpu/ops/pallas_fir.py:70",
            "launches": counts[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
        print(f"reported for {name}: {case_name} {prec}")
    kernels += [rows11["viterbi_fwd"], rows11["dfe_feedback_fwd"]]
    print("reported for viterbi_fwd and dfe_feedback_fwd: the inputs of "
          "their last launch in 11d's last run")
    kernels.append(dict(iir1_row, launches=counts["iir1_fwd"]))
    print(f"reported for iir1_fwd: phase 4's chunk, 1 x {IIR1_CHUNK} (phase "
          f"3b); launches: phase 4's")
    kernels.append(dict(mm_row, launches=dmr_launches["mm_fwd"]))
    print("reported for mm_fwd: the stream cell's chunk (phase 3c); "
          "launches: phase 5's")
    print(f"iir1_fwd held to its plain form on the CPU outside captures "
          f"(shape, dtype, nff, K: calls): {iir1_held}")
    if not any(key[:3] == ((IIR1_CHUNK,), "float32", 2) and calls == IIR1_HELD
               for key, calls in iir1_held.items()):
        fail(f"phase 4's de-emphasis (1 x {IIR1_CHUNK}) was not held to its "
             f"plain form")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

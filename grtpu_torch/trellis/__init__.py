"""gr-trellis analog: FSMs, Viterbi/SISO algorithms, turbo (PCCC/SCCC)
codecs, interleavers, and their stream-block wrappers (port of
``grtpu.trellis``)."""

from grtpu_torch.trellis.fsm import FSM, base2dec, dec2base
from grtpu_torch.trellis import fsm_utils
from grtpu_torch.trellis.interleaver import Interleaver
from grtpu_torch.trellis.algorithms import (
    calc_metric_euclidean, calc_metric_hard, calc_metric_cost,
    viterbi, viterbi_combined, siso, siso_cost,
    sccc_decoder, sccc_decoder_combined,
    pccc_decoder, pccc_decoder_combined, fsm_encode,
)
from grtpu_torch.trellis.blocks import (
    TrellisEncoder, PcccEncoder, ScccEncoder, Permutation,
    TrellisMetrics, ConstellationMetrics,
    ViterbiDecoder, ViterbiCombined, SisoF, SisoCombinedF,
    ScccDecoder, ScccDecoderCombined, PcccDecoder, PcccDecoderCombined,
)

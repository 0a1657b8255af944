"""grtpu_torch.vocoder — voice codec blocks (port of ``grtpu.vocoder``).

Waveform codecs whose per-sample feedback is a loop of small integer tensor
ops over a whole bank of channels at once (the state carries the channels
on its leading axes; on the card the steps replay from CUDA graphs,
:func:`grtpu_torch.runtime.step_graph.step_scan`), memoryless companders as
elementwise ops, and Codec2 as grtpu's host NumPy codec.

Block-name mapping (reference block -> grtpu_torch, as in grtpu):
  vocoder_alaw_encode_sb / _decode_bs   -> AlawEncode / AlawDecode
  vocoder_ulaw_encode_sb / _decode_bs   -> UlawEncode / UlawDecode
  vocoder_g721_encode_sb / _decode_bs   -> G721Encode / G721Decode
  vocoder_g723_24_* / g723_40_*         -> G723_24*/G723_40* (same pattern)
  vocoder_cvsd_encode_sb / _decode_bs   -> CvsdEncode / CvsdDecode
  vocoder_gsm_fr_encode_sp / _decode_ps -> GsmFrEncode / GsmFrDecode
  vocoder_codec2_encode_sp / _decode_ps -> Codec2Encode / Codec2Decode

All codecs are validated bit-exactly against golden vectors produced by the
reference's own C implementations (tests/data/vocoder_golden.npz).
"""

from grtpu_torch.vocoder.g711 import (
    AlawDecode,
    AlawEncode,
    UlawDecode,
    UlawEncode,
    alaw_to_linear,
    alaw_to_ulaw,
    linear_to_alaw,
    linear_to_ulaw,
    ulaw_to_alaw,
    ulaw_to_linear,
)
from grtpu_torch.vocoder.g72x import (
    G721Decode,
    G721Encode,
    G723_24Decode,
    G723_24Encode,
    G723_40Decode,
    G723_40Encode,
    g72x_decode,
    g72x_encode,
    g72x_init_state,
)
from grtpu_torch.vocoder.codec2 import Codec2, Codec2Decode, Codec2Encode
from grtpu_torch.vocoder.cvsd import CvsdDecode, CvsdEncode
from grtpu_torch.vocoder.gsm import (
    GsmFrDecode,
    GsmFrEncode,
    gsm_fr_decode,
    gsm_fr_encode,
    gsm_init_decode_state,
    gsm_init_encode_state,
)

__all__ = [
    "AlawEncode", "AlawDecode", "UlawEncode", "UlawDecode",
    "linear_to_alaw", "alaw_to_linear", "linear_to_ulaw", "ulaw_to_linear",
    "alaw_to_ulaw", "ulaw_to_alaw",
    "G721Encode", "G721Decode", "G723_24Encode", "G723_24Decode",
    "G723_40Encode", "G723_40Decode",
    "g72x_encode", "g72x_decode", "g72x_init_state",
    "CvsdEncode", "CvsdDecode",
    "Codec2", "Codec2Encode", "Codec2Decode",
    "GsmFrEncode", "GsmFrDecode", "gsm_fr_encode", "gsm_fr_decode",
    "gsm_init_encode_state", "gsm_init_decode_state",
]

"""gr-trellis block layer: stream-block wrappers over grtpu_torch.trellis.

Port of ``grtpu.trellis.blocks``.  Analogs (reference gr-trellis/src/lib/):
  * trellis_encoder_XX.cc.t            -> TrellisEncoder (streaming state)
  * trellis_pccc_encoder_XX.cc.t       -> PcccEncoder (per-block state reset)
  * trellis_sccc_encoder_XX.cc.t       -> ScccEncoder
  * trellis_permutation.cc             -> Permutation
  * trellis_metrics_X.cc.t             -> TrellisMetrics
  * trellis_viterbi_X.cc.t             -> ViterbiDecoder
  * trellis_viterbi_combined_XX.cc.t   -> ViterbiCombined
  * trellis_siso_f.cc                  -> SisoF
  * trellis_siso_combined_f.cc         -> SisoCombinedF
  * trellis_sccc_decoder(_combined)_X  -> ScccDecoder / ScccDecoderCombined
  * trellis_pccc_decoder(_combined)_X  -> PcccDecoder / PcccDecoderCombined
  * trellis_constellation_metrics_cf   -> ConstellationMetrics

Block-granular processing (the reference's set_output_multiple(K) +
per-block S0/SK reset) maps to decim/interp declared as whole-block item
counts, so a chunk always holds an integer number of K-blocks.  Where grtpu
vmaps a per-block decode, the port hands all of a chunk's K-blocks to one
batched call (the sequential Viterbi: one launch of ``viterbi_fwd`` a
chunk on the card).  Tables and constants are copied to the device once and
kept, so each block's step runs under ``run(device_loop=True)``.
"""

from __future__ import annotations

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, Port, port_c, port_f, port_i
from grtpu_torch.trellis import algorithms as alg
from grtpu_torch.trellis.fsm import FSM
from grtpu_torch.trellis.interleaver import Interleaver
from grtpu_torch.utils.device import constant


class TrellisEncoder(Block):
    """trellis_encoder_XX: run the FSM over the input symbol stream,
    carrying the state across time-blocks (the reference carries d_ST
    across work calls, trellis_encoder_XX.cc.t:72)."""

    in_ports = (port_i(),)
    out_ports = (port_i(),)

    def __init__(self, fsm: FSM, start_state: int = 0, name=None):
        super().__init__(name)
        self.fsm = fsm
        self.start_state = int(start_state)

    def init_state(self):
        return torch.tensor(self.start_state, dtype=torch.int32)

    def apply(self, state, x):
        return alg.fsm_encode(self.fsm, x, state)


class PcccEncoder(Block):
    """trellis_pccc_encoder_XX: per K-block, run FSM1 on the input and FSM2
    on the interleaved input from fixed start states; emit the combined
    symbol o1*O2 + o2 (grtpu's stride; see pccc_decoder)."""

    in_ports = (port_i(),)
    out_ports = (port_i(),)

    def __init__(self, fsm1: FSM, st1: int, fsm2: FSM, st2: int,
                 interleaver: Interleaver, blocklength: int, name=None):
        super().__init__(name)
        if fsm1.I != fsm2.I:
            raise ValueError("PCCC requires FSM1.I == FSM2.I")
        self.fsm1, self.fsm2 = fsm1, fsm2
        self.st1, self.st2 = int(st1), int(st2)
        self.inter = interleaver
        self.K = int(blocklength)
        self.decim = self.interp = self.K

    def apply(self, state, x):
        blocks = x.to(torch.int64).reshape(-1, self.K)
        inter = constant(self.inter, "INTER", x.device).long()
        _, o1 = alg.fsm_encode(self.fsm1, blocks, self.st1)
        _, o2 = alg.fsm_encode(self.fsm2, blocks[:, inter], self.st2)
        return state, (o1 * self.fsm2.O + o2).reshape(-1)


class ScccEncoder(Block):
    """trellis_sccc_encoder_XX: outer FSM -> interleave -> inner FSM per
    K-block (trellis_sccc_encoder_XX.cc.t:67-90)."""

    in_ports = (port_i(),)
    out_ports = (port_i(),)

    def __init__(self, fsm_o: FSM, st_o: int, fsm_i: FSM, st_i: int,
                 interleaver: Interleaver, blocklength: int, name=None):
        super().__init__(name)
        if fsm_o.O != fsm_i.I:
            raise ValueError("SCCC requires outer.O == inner.I")
        self.fsm_o, self.fsm_i = fsm_o, fsm_i
        self.st_o, self.st_i = int(st_o), int(st_i)
        self.inter = interleaver
        self.K = int(blocklength)
        self.decim = self.interp = self.K

    def apply(self, state, x):
        blocks = x.to(torch.int64).reshape(-1, self.K)
        inter = constant(self.inter, "INTER", x.device).long()
        _, mid = alg.fsm_encode(self.fsm_o, blocks, self.st_o)
        _, out = alg.fsm_encode(self.fsm_i, mid[:, inter], self.st_i)
        return state, out.reshape(-1)


class Permutation(Block):
    """trellis_permutation: within each packet of K symbol-blocks of
    SYMS_PER_BLOCK items, emit block TABLE[j] of the packet at position j
    (trellis_permutation.cc:66-78).  Use INTER for interleaving and DEINTER
    for the inverse."""

    def __init__(self, K: int, table, syms_per_block: int = 1,
                 dtype=torch.float32, name=None):
        super().__init__(name)
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        self.K = int(K)
        self.table = np.asarray(table, np.int64)
        self.spb = int(syms_per_block)
        self.decim = self.interp = self.K * self.spb

    def apply(self, state, x):
        pkts = x.reshape(-1, self.K, self.spb)
        out = pkts[:, constant(self, "table", x.device), :]
        return state, out.reshape(-1)


class TrellisMetrics(Block):
    """trellis_metrics_X: per trellis step, D observations -> O metric costs
    (calc_metric semantics, calc_metric.cc:30-70)."""

    out_ports = (port_f(),)

    def __init__(self, O: int, D: int, table, metric_type: str = "euclidean",
                 complex_in: bool = False, name=None):
        super().__init__(name)
        self.in_ports = (port_c() if complex_in else port_f(),)
        self.O, self.D = int(O), int(D)
        self.table = np.asarray(table)
        self.metric_type = metric_type
        self.decim, self.interp = self.D, self.O

    def apply(self, state, x):
        m = alg.calc_metric_cost(x, constant(self, "table", x.device), self.D,
                                 self.metric_type)
        return state, m.reshape(-1)


class ConstellationMetrics(Block):
    """trellis_constellation_metrics_cf: metrics against a digital
    constellation's points (trellis_constellation_metrics_cf.cc).  Takes a
    constellation object (its ``points``) or the points themselves."""

    in_ports = (port_c(),)
    out_ports = (port_f(),)

    def __init__(self, constellation, metric_type: str = "euclidean",
                 name=None):
        super().__init__(name)
        pts = getattr(constellation, "points", constellation)
        pts = np.asarray(pts() if callable(pts) else pts, np.complex64)
        self.table = pts
        self.O = len(pts)
        self.metric_type = metric_type
        self.decim, self.interp = 1, self.O

    def apply(self, state, x):
        m = alg.calc_metric_cost(x, constant(self, "table", x.device), 1,
                                 self.metric_type)
        return state, m.reshape(-1)


class _BlockwiseDecoder(Block):
    """Shared shape plumbing: consume whole K-blocks of per-step metric/
    observation items and decode the chunk's blocks in one batched call."""

    def __init__(self, K: int, items_per_step: int, complex_in: bool,
                 name=None):
        super().__init__(name)
        self.in_ports = (port_c() if complex_in else port_f(),)
        self.out_ports = (port_i(),)
        self.K = int(K)
        self.decim = self.K * int(items_per_step)
        self.interp = self.K

    def _decode_blocks(self, blocks):
        """(nblocks, decim) items -> (nblocks, K) int32 decisions."""
        raise NotImplementedError

    def _table(self, x):
        return constant(self, "table", x.device)

    def apply(self, state, x):
        out = self._decode_blocks(x.reshape(-1, self.decim))
        return state, out.reshape(-1).to(torch.int32)


class ViterbiDecoder(_BlockwiseDecoder):
    """trellis_viterbi_X: per K-block Viterbi over (K*O,) metric costs
    with fixed S0/SK (trellis_viterbi_X.cc.t:60-61)."""

    def __init__(self, fsm: FSM, K: int, S0: int = 0, SK: int = -1,
                 parallel=None, name=None):
        super().__init__(K, fsm.O, False, name)
        self.fsm, self.S0, self.SK = fsm, int(S0), int(SK)
        self.parallel = parallel

    def _decode_blocks(self, blocks):
        m = -blocks.reshape(-1, self.K, self.fsm.O)   # costs -> rewards
        return alg.viterbi(self.fsm, m, self.S0, self.SK,
                           parallel=self.parallel)


class ViterbiCombined(_BlockwiseDecoder):
    """trellis_viterbi_combined_XX: fused calc_metric + Viterbi."""

    def __init__(self, fsm: FSM, K: int, S0: int, SK: int, D: int,
                 table, metric_type: str = "euclidean",
                 complex_in: bool = True, parallel=None, name=None):
        super().__init__(K, D, complex_in, name)
        self.fsm, self.S0, self.SK, self.D = fsm, int(S0), int(SK), int(D)
        self.table = np.asarray(table)
        self.metric_type = metric_type
        self.parallel = parallel

    def _decode_blocks(self, blocks):
        m = alg.calc_metric_cost(blocks, self._table(blocks), self.D,
                                 self.metric_type)
        return alg.viterbi(self.fsm, -m, self.S0, self.SK,
                           parallel=self.parallel)


class SisoF(Block):
    """trellis_siso_f: per K-block SISO; input (K*O,) metric costs, output
    (K*I,) input-posterior costs if POSTI (default) else (K*O,) output
    posteriors (trellis_siso_f.cc:79-89)."""

    in_ports = (port_f(),)
    out_ports = (port_f(),)

    def __init__(self, fsm: FSM, K: int, S0: int = 0, SK: int = -1,
                 posti: bool = True, sum_product: bool = False,
                 parallel=None, name=None):
        super().__init__(name)
        self.fsm, self.K = fsm, int(K)
        self.S0, self.SK = int(S0), int(SK)
        self.posti = bool(posti)
        self.sum_product = bool(sum_product)
        self.parallel = parallel
        self.decim = self.K * fsm.O
        self.interp = self.K * (fsm.I if posti else fsm.O)

    def _prioro(self, blocks):
        return blocks.reshape(-1, self.K, self.fsm.O)

    def apply(self, state, x):
        prioro = self._prioro(x.reshape(-1, self.decim))
        priori = prioro.new_zeros(prioro.shape[:-1] + (self.fsm.I,))
        out = alg.siso_cost(self.fsm, priori, prioro, self.S0, self.SK,
                            posti=self.posti, posto=not self.posti,
                            sum_product=self.sum_product,
                            parallel=self.parallel)
        return state, out.reshape(-1)


class SisoCombinedF(SisoF):
    """trellis_siso_combined_f: SISO with in-loop metric calculation."""

    def __init__(self, fsm: FSM, K: int, S0: int, SK: int, D: int, table,
                 metric_type: str = "euclidean", posti: bool = True,
                 sum_product: bool = False, complex_in: bool = False,
                 parallel=None, name=None):
        super().__init__(fsm, K, S0, SK, posti, sum_product, parallel, name)
        self.in_ports = (port_c() if complex_in else port_f(),)
        self.D = int(D)
        self.table = np.asarray(table)
        self.metric_type = metric_type
        self.decim = self.K * self.D

    def _prioro(self, blocks):
        return alg.calc_metric_cost(blocks, constant(self, "table",
                                                     blocks.device),
                                    self.D, self.metric_type)


class ScccDecoder(_BlockwiseDecoder):
    """trellis_sccc_decoder_X: per K-block iterative SCCC decode over
    (K * FSMi.O,) metric costs."""

    def __init__(self, fsm_o: FSM, sto0: int, stok: int, fsm_i: FSM,
                 sti0: int, stik: int, interleaver: Interleaver, K: int,
                 iterations: int = 10, sum_product: bool = False,
                 parallel=None, name=None):
        super().__init__(K, fsm_i.O, False, name)
        self.fsm_o, self.fsm_i, self.inter = fsm_o, fsm_i, interleaver
        self.sto0, self.stok = int(sto0), int(stok)
        self.sti0, self.stik = int(sti0), int(stik)
        self.iterations = int(iterations)
        self.sum_product = bool(sum_product)
        self.parallel = parallel

    def _metrics(self, blocks):
        return blocks.reshape(-1, self.K, self.fsm_i.O)

    def _decode_blocks(self, blocks):
        return alg.sccc_decoder(self.fsm_o, self.fsm_i, self.inter,
                                self._metrics(blocks), self.iterations,
                                self.sto0, self.stok, self.sti0, self.stik,
                                self.sum_product, parallel=self.parallel)


class ScccDecoderCombined(ScccDecoder):
    """trellis_sccc_decoder_combined_XX: observations in, decisions out."""

    def __init__(self, fsm_o: FSM, sto0: int, stok: int, fsm_i: FSM,
                 sti0: int, stik: int, interleaver: Interleaver, K: int,
                 D: int, table, metric_type: str = "euclidean",
                 scaling: float = 1.0, iterations: int = 10,
                 sum_product: bool = False, complex_in: bool = True,
                 parallel=None, name=None):
        super().__init__(fsm_o, sto0, stok, fsm_i, sti0, stik, interleaver,
                         K, iterations, sum_product, parallel, name)
        self.in_ports = (port_c() if complex_in else port_f(),)
        self.decim = self.K * int(D)
        self.D, self.table = int(D), np.asarray(table)
        self.metric_type, self.scaling = metric_type, float(scaling)

    def _metrics(self, blocks):
        return alg.calc_metric_cost(blocks, self._table(blocks), self.D,
                                    self.metric_type) * self.scaling


class PcccDecoder(_BlockwiseDecoder):
    """trellis_pccc_decoder_X: per K-block turbo decode over
    (K * O1 * O2,) combined metric costs."""

    def __init__(self, fsm1: FSM, st10: int, st1k: int, fsm2: FSM,
                 st20: int, st2k: int, interleaver: Interleaver, K: int,
                 iterations: int = 10, sum_product: bool = False,
                 parallel=None, name=None):
        super().__init__(K, fsm1.O * fsm2.O, False, name)
        self.fsm1, self.fsm2, self.inter = fsm1, fsm2, interleaver
        self.st10, self.st1k = int(st10), int(st1k)
        self.st20, self.st2k = int(st20), int(st2k)
        self.iterations = int(iterations)
        self.sum_product = bool(sum_product)
        self.parallel = parallel

    def _metrics(self, blocks):
        return blocks.reshape(-1, self.K, self.fsm1.O * self.fsm2.O)

    def _decode_blocks(self, blocks):
        return alg.pccc_decoder(self.fsm1, self.fsm2, self.inter,
                                self._metrics(blocks), self.iterations,
                                self.st10, self.st1k, self.st20, self.st2k,
                                self.sum_product, parallel=self.parallel)


class PcccDecoderCombined(PcccDecoder):
    """trellis_pccc_decoder_combined_XX."""

    def __init__(self, fsm1: FSM, st10: int, st1k: int, fsm2: FSM,
                 st20: int, st2k: int, interleaver: Interleaver, K: int,
                 D: int, table, metric_type: str = "euclidean",
                 scaling: float = 1.0, iterations: int = 10,
                 sum_product: bool = False, complex_in: bool = True,
                 parallel=None, name=None):
        super().__init__(fsm1, st10, st1k, fsm2, st20, st2k, interleaver, K,
                         iterations, sum_product, parallel, name)
        self.in_ports = (port_c() if complex_in else port_f(),)
        self.decim = self.K * int(D)
        self.D, self.table = int(D), np.asarray(table)
        self.metric_type, self.scaling = metric_type, float(scaling)

    def _metrics(self, blocks):
        return alg.calc_metric_cost(blocks, self._table(blocks), self.D,
                                    self.metric_type) * self.scaling

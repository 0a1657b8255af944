"""Generic trellis algorithms: Viterbi and SISO (max-log BCJR).

Port of ``grtpu.trellis.algorithms`` (gr-trellis core_algorithms.{h,cc}):
table-driven Viterbi over any FSM, metric types (euclidean on
constellation points / hard symbol hamming), the SISO forward-backward used
by PCCC/SCCC turbo schemes, and the turbo decoders.

Every function takes leading batch axes before its (T, ...) arrays, where
grtpu vmaps one block at a time: a batch of K-blocks is one call.  The time
recursions are Python step loops over whole-batch tensors, except the
sequential Viterbi on a CUDA tensor, which is one launch of the hand kernel
``viterbi_fwd`` (:mod:`grtpu_torch.ops.cuda_trellis`; its plain twin, the
same step loop, runs on a CPU tensor).  The log-depth forms
(``parallel=True``) run :func:`associative_scan`, which combines elements in
the order of ``jax.lax.associative_scan``, so their sums round as grtpu's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from grtpu_torch.ops import cuda_trellis
from grtpu_torch.trellis.fsm import FSM

NEG = -1e9
INF = 1e9


def _tensor(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(like.device)
    return torch.as_tensor(np.asarray(v), device=like.device)


def _const(owner, name: str, make, device) -> torch.Tensor:
    """The constant ``make()`` (numpy) as a tensor on ``device``, made once
    per device and kept on ``owner`` (a captured step then copies nothing
    to the card)."""
    cache = owner.__dict__.setdefault("_torch_const", {})
    key = (name, torch.device(device))
    if key not in cache:
        cache[key] = torch.from_numpy(np.ascontiguousarray(make())).to(key[1])
    return cache[key]


def _index(fsm: FSM, name: str, device) -> torch.Tensor:
    """The FSM's table ``name`` (NS, OS, PS, PI) as int64 on ``device``."""
    return _const(fsm, name, lambda: np.asarray(getattr(fsm, name), np.int64),
                  device)


def _boundary(S: int, state: int, other: float, device) -> torch.Tensor:
    """(S,) float32 start or end metrics: 0 at ``state`` and ``other``
    elsewhere, all 0 when ``state`` < 0.  Made on the device without a
    host-to-device copy (a Python scalar stored into a CUDA tensor is one,
    which a captured step cannot hold)."""
    if state < 0:
        return torch.zeros(S, dtype=torch.float32, device=device)
    return torch.where(torch.arange(S, device=device) == state, 0.0,
                       other).to(torch.float32)


def _onehot(fsm: FSM, device) -> torch.Tensor:
    """(S, I, S) bool: onehot[s, i, NS[s, i]]."""
    def make():
        oh = np.full((fsm.S, fsm.I, fsm.S), False)
        oh[np.arange(fsm.S)[:, None], np.arange(fsm.I)[None, :],
           np.asarray(fsm.NS)] = True
        return oh

    return _const(fsm, "onehot", make, device)


def _permutation(interleaver, name: str, device) -> torch.Tensor:
    """The interleaver's INTER or DEINTER as int64 on ``device``."""
    return _const(interleaver, name,
                  lambda: getattr(interleaver, name).astype(np.int64), device)


def _obs_table(obs: torch.Tensor, table, dim: int):
    """(..., T, dim) observations and (O, dim) table rows in one single
    precision type: complex64 if either is complex, else float32 (grtpu's
    promotion without x64)."""
    t = _tensor(table, obs)
    cplx = t.is_complex() or obs.is_complex()
    dtype = torch.complex64 if cplx else torch.float32
    o = obs.to(dtype).reshape(obs.shape[:-1] + (-1, dim))
    return o, t.to(dtype).reshape(-1, dim)


def _pairwise_sq(o: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    diff = o[..., :, None, :] - t[None, :, :]
    if diff.is_complex():
        return (diff.abs() ** 2).sum(-1)
    return (diff ** 2).sum(-1)


def calc_metric_euclidean(obs: torch.Tensor, table, dim: int = 1):
    """(..., T*dim) observations vs O constellation points of dimension dim
    -> (..., T, O) NEGATIVE squared distances (higher = better), matching
    calc_metric's TRELLIS_EUCLIDEAN (up to sign; we maximize)."""
    o, t = _obs_table(obs, table, dim)
    return -_pairwise_sq(o, t)


def calc_metric_hard(obs_symbols: torch.Tensor, O: int) -> torch.Tensor:
    """(..., T) hard symbols -> (..., T, O) 0/-1 match metric
    (TRELLIS_HARD_SYMBOL)."""
    ar = torch.arange(O, device=obs_symbols.device)
    match = ar == obs_symbols.to(torch.int64)[..., None]
    return torch.where(match, 0.0, -1.0).to(torch.float32)


# ----------------------------------------------------------------- scans
def _sl(x: torch.Tensor, dim: int, start, stop=None, step=1) -> torch.Tensor:
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(start, stop, step)
    return x[tuple(idx)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """out[0::2] = a, out[1::2] = b along ``dim`` (len(a) - len(b) in
    {0, 1})."""
    nb = b.shape[dim]
    pair = torch.stack([_sl(a, dim, 0, nb), b], dim=dim + 1)
    shape = list(a.shape)
    shape[dim] = 2 * nb
    out = pair.reshape(shape)
    if a.shape[dim] > nb:
        out = torch.cat([out, _sl(a, dim, nb, None)], dim=dim)
    return out


def associative_scan(fn, elems: torch.Tensor, dim: int = 0,
                     reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of ``elems`` along ``dim`` under the associative
    ``fn(earlier, later)``, combining pairs exactly as
    ``jax.lax.associative_scan`` does (odd/even recursion), so that a
    combine whose float sums depend on grouping rounds as grtpu's.  With
    ``reverse`` the scan runs from the end and ``fn`` receives (later,
    earlier), as in JAX."""
    dim = dim % elems.ndim

    def scan(el):
        n = el.shape[dim]
        if n < 2:
            return el
        odd = scan(fn(_sl(el, dim, 0, -1, 2), _sl(el, dim, 1, None, 2)))
        if n % 2 == 0:
            even = fn(_sl(odd, dim, 0, -1), _sl(el, dim, 2, None, 2))
        else:
            even = fn(odd, _sl(el, dim, 2, None, 2))
        even = torch.cat([_sl(el, dim, 0, 1), even], dim=dim)
        return _interleave(even, odd, dim)

    if reverse:
        return torch.flip(scan(torch.flip(elems, (dim,))), (dim,))
    return scan(elems)


# ---------------------------------------------------------------- Viterbi
def viterbi(fsm: FSM, metrics: torch.Tensor, start_state: int = 0,
            end_state: int = -1,
            parallel: Optional[bool] = None) -> torch.Tensor:
    """Table-driven Viterbi (core_algorithms viterbi_algorithm).

    metrics: (..., T, O) per-step per-output-symbol metrics (higher better);
    leading axes are independent rows.  Returns (..., T) int32 decoded input
    symbols.

    The sequential form (the default) is ``cuda_trellis.viterbi_fwd``: the
    hand kernel on a CUDA tensor, its plain twin on a CPU one; the first
    index wins a tie, as grtpu's ``argmax``.  ``parallel=True`` opts into the
    log-depth formulation (:func:`_viterbi_parallel`, torch ops), grtpu's
    latency form; its tie-break may differ."""
    metrics = metrics.to(torch.float32)
    if _use_parallel(fsm.S, parallel):
        lead = metrics.shape[:-2]
        rows = metrics.reshape((-1,) + metrics.shape[-2:])
        out = [_viterbi_parallel(fsm, r, start_state, end_state) for r in rows]
        t_len = metrics.shape[-2]
        if not out:
            return metrics.new_zeros(lead + (t_len,), dtype=torch.int32)
        return torch.stack(out).reshape(lead + (t_len,))
    lead, (t_len, o) = metrics.shape[:-2], metrics.shape[-2:]
    tab = cuda_trellis.tables(fsm, metrics.device)
    out = cuda_trellis.viterbi_fwd(metrics.reshape(-1, t_len, o), tab,
                                   start_state, end_state)
    return out.reshape(lead + (t_len,))


def _viterbi_parallel(fsm: FSM, metrics: torch.Tensor, start_state: int,
                      end_state: int) -> torch.Tensor:
    """Log-depth Viterbi over one row (T, O): max-plus prefix products for
    the path metrics + pointer-doubling composition of best-predecessor maps
    for traceback.  Exact same optimum as the sequential scan (tie-breaking
    may differ)."""
    S = fsm.S
    T = metrics.shape[0]
    dev = metrics.device
    oh = _onehot(fsm, dev)
    vals = metrics[:, _index(fsm, "OS", dev)]                  # (T, S, I)
    masked = torch.where(oh[None], vals[..., None], NEG)       # (T, S, I, S)
    R = masked.amax(dim=2)                                     # edge rewards
    edge_in = masked.argmax(dim=2)                             # (T, S, S)

    def mm(a, b):
        return torch.clamp_min((a[..., :, :, None]
                                + b[..., None, :, :]).amax(-2), NEG)

    P = associative_scan(mm, R)                                # prefix products
    a0 = _boundary(S, start_state, NEG, dev)
    av = (a0[None, :, None] + P[:-1]).amax(1)                  # (T-1, S)
    alphas = torch.cat([a0[None], av], dim=0)                  # alpha BEFORE t
    bp = (alphas[:, :, None] + R).argmax(1)                    # (T, S)
    alpha_T = (a0[:, None] + P[-1]).amax(0)
    s_end = (alpha_T.argmax() if end_state < 0
             else torch.full((), end_state, dtype=torch.int64, device=dev))
    # C[t] = F_t o F_{t+1} o ... o F_{T-1}; s_t = C[t][s_end]
    C = associative_scan(lambda a, b: torch.gather(b, -1, a), bp,
                         reverse=True)
    s_end = s_end.reshape(1)     # a 0-d index would read the card
    s_all = C.index_select(1, s_end)[:, 0]
    s_next = torch.cat([s_all[1:], s_end])
    return edge_in[torch.arange(T, device=dev), s_all,
                   s_next].to(torch.int32)


def viterbi_combined(fsm: FSM, observations: torch.Tensor, constellation,
                     dim: int = 1, start_state: int = 0, end_state: int = -1,
                     parallel: Optional[bool] = None) -> torch.Tensor:
    """viterbi_combined_XX: metric calculation fused with decoding."""
    m = calc_metric_euclidean(observations, constellation, dim)
    return viterbi(fsm, m, start_state, end_state, parallel=parallel)


# ------------------------------------------------------------------- SISO
def _scan_both(a0, b0, Ef, Eb, PS, NS, reduce):
    """The forward (at t) and backward (at T-1-t) recursions advanced
    together, each emitting its carry before the update; returns (alphas,
    betas) with betas in forward time order."""
    a, b = a0, b0
    T = Ef.shape[-3]
    alphas, betas = [], []
    for t in range(T):
        alphas.append(a)
        betas.append(b)
        a = reduce(a[..., PS] + Ef[..., t, :, :])
        b = reduce(b[..., NS] + Eb[..., T - 1 - t, :, :])
    return torch.stack(alphas, dim=-2), torch.stack(betas[::-1], dim=-2)


def siso(fsm: FSM, metrics: torch.Tensor, start_state: int = 0,
         end_state: int = -1,
         prior_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Max-log SISO (core_algorithms siso_algorithm with max* ~ max):
    forward/backward recursions -> per-step input-symbol APPs (log domain,
    normalized so max = 0).  metrics (..., T, O); returns (..., T, I)."""
    S, I = fsm.S, fsm.I
    dev = metrics.device
    metrics = metrics.to(torch.float32)
    T = metrics.shape[-2]
    NS = _index(fsm, "NS", dev)
    OS = _index(fsm, "OS", dev)
    PS = _index(fsm, "PS", dev).clamp(min=0)
    PI = _index(fsm, "PI", dev).clamp(min=0)
    pvalid = _index(fsm, "PS", dev) >= 0
    edge_out_pred = OS[PS, PI]

    if prior_in is None:
        prior_in = metrics.new_zeros(metrics.shape[:-2] + (T, I))
    prior_in = prior_in.to(torch.float32)

    def rowmax_norm(p):
        pmax = p.amax(-1, keepdim=True)
        return p - torch.where(pmax < NEG * 0.5, 0.0, pmax)

    metrics = rowmax_norm(metrics)
    prior_in = rowmax_norm(prior_in)

    a0 = _boundary(S, start_state, NEG, dev)
    bT = _boundary(S, end_state, NEG, dev)
    lead = metrics.shape[:-2]
    a0, bT = a0.expand(lead + (S,)), bT.expand(lead + (S,))

    Ef = torch.where(pvalid, metrics[..., edge_out_pred] + prior_in[..., PI],
                     NEG)
    Eb = metrics[..., OS] + prior_in[..., None, :]
    alphas, betas = _scan_both(a0, bT, Ef, Eb, PS, NS,
                               lambda v: v.amax(-1))
    val = alphas[..., :, :, None] + betas[..., NS] + Eb      # (..., T, S, I)
    o = val.amax(-2)
    return o - o.amax(-1, keepdim=True)


def _reduce(x: torch.Tensor, axis: int, sum_product: bool) -> torch.Tensor:
    """min (TRELLIS_MIN_SUM) or min* (TRELLIS_SUM_PRODUCT) reduction over
    cost-domain values (core_algorithms.cc min/min_star)."""
    if sum_product:
        return -torch.logsumexp(-x, dim=axis)
    return x.amin(axis)


_PARALLEL_MAX_S = 16


def _use_parallel(S: int, parallel: Optional[bool]) -> bool:
    if parallel is None:
        return False
    if parallel and S > _PARALLEL_MAX_S:
        raise ValueError(
            f"parallel trellis mode needs S <= {_PARALLEL_MAX_S} (got {S})")
    return bool(parallel)


def _semiring_mm(A: torch.Tensor, B: torch.Tensor,
                 sum_product: bool) -> torch.Tensor:
    """(..., S, S) (x) (..., S, S) in the (min,+) or log semiring."""
    X = A[..., :, :, None] + B[..., None, :, :]
    return torch.clamp_max(_reduce(X, -2, sum_product), INF)


def _edge_costs(fsm: FSM, priori: torch.Tensor,
                prioro: torch.Tensor) -> torch.Tensor:
    """Per-step edge-cost matrices E[..., t, s, s'] = min over parallel
    edges (s --i--> s') of priori[t, i] + prioro[t, OS[s, i]] (INF if no
    edge)."""
    dev = priori.device
    oh = _onehot(fsm, dev)
    vals = priori[..., :, None, :] + prioro[..., _index(fsm, "OS", dev)]
    masked = torch.where(oh, vals[..., None], INF)
    return masked.amin(-2)                                     # (..., K, S, S)


def _alphas_parallel(E: torch.Tensor, a0: torch.Tensor,
                     sum_product: bool) -> torch.Tensor:
    """alpha BEFORE each step: alphas[t] = a0 (x) E_0 (x) ... (x) E_{t-1}."""
    P = associative_scan(lambda a, b: _semiring_mm(a, b, sum_product), E,
                         dim=-3)
    av = _reduce(a0[..., None, :, None] + P[..., :-1, :, :], -2, sum_product)
    a0b = a0.expand(E.shape[:-3] + a0.shape[-1:])
    return torch.cat([a0b[..., None, :], av], dim=-2)


def _betas_parallel(E: torch.Tensor, bK: torch.Tensor,
                    sum_product: bool) -> torch.Tensor:
    """beta AFTER each step: betas[t] = E_{t+1} (x) ... (x) E_{K-1} (x) bK."""
    R = associative_scan(lambda a, b: _semiring_mm(b, a, sum_product), E,
                         dim=-3, reverse=True)
    bv = _reduce(R[..., 1:, :, :] + bK[..., None, None, :], -1, sum_product)
    bKb = bK.expand(E.shape[:-3] + bK.shape[-1:])
    return torch.cat([bv, bKb[..., None, :]], dim=-2)


def calc_metric_cost(obs: torch.Tensor, table, dim: int = 1,
                     metric_type: str = "euclidean") -> torch.Tensor:
    """calc_metric (calc_metric.cc:30-70): (..., T*dim) observations vs O
    table rows of dimension dim -> (..., T, O) POSITIVE costs.

    "euclidean": squared distance.  "hard_symbol": 0 for the nearest table
    row, 1 elsewhere.  ("hard_bit" is unimplemented in the reference too.)
    """
    o, t = _obs_table(obs, table, dim)
    d = _pairwise_sq(o, t)
    if metric_type == "euclidean":
        return d
    if metric_type == "hard_symbol":
        best = d.argmin(-1)
        ar = torch.arange(d.shape[-1], device=d.device)
        return torch.where(ar == best[..., None], 0.0, 1.0).to(torch.float32)
    raise ValueError(f"unknown metric type {metric_type!r}")


def _group_perm(fsm: FSM) -> np.ndarray:
    """The S*I edges grouped by output symbol (padded with the dummy index
    S*I): (O, cmax)."""
    S, I = fsm.S, fsm.I
    OS_flat = np.asarray(fsm.OS).reshape(-1)
    counts = np.bincount(OS_flat, minlength=fsm.O)
    cmax = int(counts.max())
    perm = np.full((fsm.O, cmax), S * I, np.int64)
    for n2 in range(fsm.O):
        idx = np.nonzero(OS_flat == n2)[0]
        perm[n2, : len(idx)] = idx
    return perm


def siso_cost(fsm: FSM, priori: torch.Tensor, prioro: torch.Tensor,
              start_state: int = 0, end_state: int = -1,
              posti: bool = True, posto: bool = False,
              sum_product: bool = False,
              parallel: Optional[bool] = None, unroll: int = 8):
    """siso_algorithm (core_algorithms.cc:418-563) in the cost domain.

    Args:
      priori: (..., K, I) input-symbol prior costs.
      prioro: (..., K, O) output-symbol prior costs (channel metrics).
      posti/posto: which posteriors to return (POSTI/POSTO flags).
      parallel: opt into the log-depth recursion (requires S <=
        _PARALLEL_MAX_S).  Default: sequential step loops.
      unroll: accepted for grtpu's signature (its scan's unroll factor).

    Returns (..., K, I), (..., K, O), or both per the flags; each row is
    normalized so its min is 0.  As in grtpu, each prior row is first
    normalized by its finite min and the per-step norm is dropped (a common
    constant that cancels in the row-normalized posteriors).
    """
    S, I = fsm.S, fsm.I
    priori = torch.as_tensor(priori, dtype=torch.float32)
    prioro = torch.as_tensor(prioro, dtype=torch.float32,
                             device=priori.device)
    dev = priori.device
    NS = _index(fsm, "NS", dev)
    OS = _index(fsm, "OS", dev)

    def rownorm(p):
        pmin = p.amin(-1, keepdim=True)
        return p - torch.where(pmin > INF * 0.5, 0.0, pmin)

    priori = rownorm(priori)
    prioro = rownorm(prioro)
    lead = torch.broadcast_shapes(priori.shape[:-2], prioro.shape[:-2])

    a0 = _boundary(S, start_state, INF, dev)
    bK = _boundary(S, end_state, INF, dev)

    if _use_parallel(S, parallel):
        E = _edge_costs(fsm, priori, prioro)
        alphas = _alphas_parallel(E, a0, sum_product)        # (..., K, S)
        betas = _betas_parallel(E, bK, sum_product)          # (..., K, S)
    else:
        PS = _index(fsm, "PS", dev).clamp(min=0)             # (S, deg)
        PI = _index(fsm, "PI", dev).clamp(min=0)
        pvalid = _index(fsm, "PS", dev) >= 0
        edge_out_pred = OS[PS, PI]                           # (S, deg)
        Ef = torch.where(pvalid, priori[..., PI] + prioro[..., edge_out_pred],
                         INF)                                # (..., K, S, deg)
        Eb = priori[..., :, None, :] + prioro[..., OS]       # (..., K, S, I)
        alphas, betas = _scan_both(
            a0.expand(lead + (S,)), bK.expand(lead + (S,)), Ef, Eb, PS, NS,
            lambda v: _reduce(v, -1, sum_product))

    out = []
    if posti:
        # post_in[t,i] = reduce_j alpha[t,j] + prioro[t, OS[j,i]] + beta[t+1, NS[j,i]]
        val = alphas[..., :, :, None] + prioro[..., OS] + betas[..., NS]
        pi_ = _reduce(val, -2, sum_product)
        out.append(pi_ - pi_.amin(-1, keepdim=True))
    if posto:
        # post_out[t,n] = reduce over edges (j,i) with OS[j,i] == n of
        #                 alpha[t,j] + priori[t,i] + beta[t+1, NS[j,i]],
        # the edges grouped by output symbol with a static permutation
        perm = _const(fsm, "group_perm", lambda: _group_perm(fsm), dev)
        val = (alphas[..., :, :, None] + priori[..., :, None, :]
               + betas[..., NS])
        k = val.shape[-3]
        val = val.reshape(val.shape[:-2] + (S * I,))          # (..., K, S*I)
        val = torch.cat([val, val.new_full(val.shape[:-1] + (1,), INF)],
                        dim=-1)
        grouped = val[..., perm.reshape(-1)].reshape(
            val.shape[:-2] + (k, fsm.O, perm.shape[1]))
        po_ = _reduce(grouped, -1, sum_product)
        out.append(po_ - po_.amin(-1, keepdim=True))
    return tuple(out) if len(out) == 2 else out[0]


def sccc_decoder(fsm_o: FSM, fsm_i: FSM, interleaver,
                 iprioro: torch.Tensor, iterations: int = 10, sto0: int = 0,
                 stok: int = -1, sti0: int = 0, stik: int = -1,
                 sum_product: bool = False,
                 parallel: Optional[bool] = None,
                 unroll: int = 8) -> torch.Tensor:
    """Serially-concatenated-code turbo decoder
    (core_algorithms.cc sccc_decoder :973-1067).

    iprioro: (..., K, FSMi.O) inner channel metric costs.  Requires
    FSMo.O == FSMi.I (the SCCC wiring contract).  Returns (..., K) int32
    hard outer inputs.
    """
    if fsm_o.O != fsm_i.I:
        raise ValueError("SCCC requires outer.O == inner.I")
    iprioro = torch.as_tensor(iprioro, dtype=torch.float32)
    dev = iprioro.device
    K = iprioro.shape[-2]
    lead = iprioro.shape[:-2]
    INTER = _permutation(interleaver, "INTER", dev)
    DEINTER = _permutation(interleaver, "DEINTER", dev)
    ipriori = iprioro.new_zeros(lead + (K, fsm_i.I))
    opriori = iprioro.new_zeros(lead + (K, fsm_o.I))
    oposti = None
    for rep in range(iterations):
        iposti = siso_cost(fsm_i, ipriori, iprioro, sti0, stik,
                           posti=True, sum_product=sum_product,
                           parallel=parallel, unroll=unroll)
        oprioro = iposti[..., DEINTER, :]      # deinterleave inner -> outer
        if rep < iterations - 1:
            oposto = siso_cost(fsm_o, opriori, oprioro, sto0, stok,
                               posti=False, posto=True,
                               sum_product=sum_product, parallel=parallel,
                               unroll=unroll)
            ipriori = oposto[..., INTER, :]    # re-interleave outer -> inner
        else:
            oposti = siso_cost(fsm_o, opriori, oprioro, sto0, stok,
                               posti=True, sum_product=sum_product,
                               parallel=parallel, unroll=unroll)
    return oposti.argmin(-1).to(torch.int32)


def sccc_decoder_combined(fsm_o: FSM, fsm_i: FSM, interleaver,
                          observations: torch.Tensor, table,
                          dim: int = 1, metric_type: str = "euclidean",
                          scaling: float = 1.0, iterations: int = 10,
                          sum_product: bool = False, **kw) -> torch.Tensor:
    """sccc_decoder_combined (core_algorithms.cc:780-...): metric
    calculation fused with decoding (the whole metric vector scaled, as in
    grtpu: the reference's loop touches element 0 only)."""
    m = calc_metric_cost(observations, table, dim, metric_type) * scaling
    return sccc_decoder(fsm_o, fsm_i, interleaver, m, iterations,
                        sum_product=sum_product, **kw)


def pccc_decoder(fsm1: FSM, fsm2: FSM, interleaver, cprioro: torch.Tensor,
                 iterations: int = 10, st10: int = 0, st1k: int = -1,
                 st20: int = 0, st2k: int = -1,
                 sum_product: bool = False,
                 parallel: Optional[bool] = None,
                 unroll: int = 8) -> torch.Tensor:
    """Parallel-concatenated (turbo) decoder
    (core_algorithms.cc pccc_decoder :1105-1207).

    cprioro: (..., K, O1*O2) combined-output metric costs, combined symbol
    c = o1 * FSM2.O + o2 (grtpu's collision-free stride).  Returns (..., K)
    int32 hard decisions for the common input.
    """
    if fsm1.I != fsm2.I:
        raise ValueError("PCCC requires FSM1.I == FSM2.I")
    cprioro = torch.as_tensor(cprioro, dtype=torch.float32)
    dev = cprioro.device
    K = cprioro.shape[-2]
    lead = cprioro.shape[:-2]
    INTER = _permutation(interleaver, "INTER", dev)
    DEINTER = _permutation(interleaver, "DEINTER", dev)
    comb = cprioro.reshape(lead + (K, fsm1.O, fsm2.O))
    prioro1 = _reduce(comb, -1, sum_product)   # (..., K, O1)
    prioro2 = _reduce(comb, -2, sum_product)   # (..., K, O2)
    priori1 = cprioro.new_zeros(lead + (K, fsm1.I))
    posti1 = None
    for _ in range(iterations):
        posti1 = siso_cost(fsm1, priori1, prioro1, st10, st1k,
                           posti=True, sum_product=sum_product,
                           parallel=parallel, unroll=unroll)
        priori2 = posti1[..., INTER, :]
        posti2 = siso_cost(fsm2, priori2, prioro2, st20, st2k,
                           posti=True, sum_product=sum_product,
                           parallel=parallel, unroll=unroll)
        priori1 = posti2[..., DEINTER, :]
    total = _reduce(torch.stack([priori1, posti1], 0), 0, sum_product)
    return total.argmin(-1).to(torch.int32)


def pccc_decoder_combined(fsm1: FSM, fsm2: FSM, interleaver,
                          observations: torch.Tensor, table,
                          dim: int = 1, metric_type: str = "euclidean",
                          scaling: float = 1.0, iterations: int = 10,
                          sum_product: bool = False, **kw) -> torch.Tensor:
    """pccc_decoder_combined (core_algorithms.cc:1243-...); same whole-vector
    scaling as sccc_decoder_combined."""
    m = calc_metric_cost(observations, table, dim, metric_type) * scaling
    return pccc_decoder(fsm1, fsm2, interleaver, m, iterations,
                        sum_product=sum_product, **kw)


def fsm_encode(fsm: FSM, inputs: torch.Tensor, start_state=0):
    """Run the FSM (trellis_encoder_XX work) over (..., T) input symbols:
    returns (final_state, (..., T) int32 output symbols).

    The state sequence is a composition of the per-step maps s -> NS[s,
    i_t], prefix-composed in log depth (:func:`associative_scan`), so the
    call has no per-symbol loop.  ``start_state`` is an int or a tensor of
    the leading shape."""
    inputs = torch.as_tensor(inputs).to(torch.int64)
    dev = inputs.device
    NS = _index(fsm, "NS", dev)
    OS = _index(fsm, "OS", dev)
    lead, T = inputs.shape[:-1], inputs.shape[-1]
    if isinstance(start_state, torch.Tensor):
        s0 = start_state.to(device=dev, dtype=torch.int64).expand(lead)
    else:   # made on the device: a captured step copies nothing to it
        s0 = torch.full(lead, int(start_state), dtype=torch.int64, device=dev)
    if T == 0:
        return s0.to(torch.int32), inputs.new_zeros(inputs.shape,
                                                    dtype=torch.int32)
    maps = NS[:, inputs].movedim(0, -1)                       # (..., T, S)
    comp = associative_scan(lambda a, b: torch.gather(b, -1, a), maps,
                            dim=-2)                           # F_t o..o F_0
    after = torch.gather(comp, -1, s0[..., None, None].expand(
        lead + (T, 1)))[..., 0]                               # state after t
    before = torch.cat([s0[..., None], after[..., :-1]], dim=-1)
    out = OS[before, inputs].to(torch.int32)
    return after[..., -1].to(torch.int32), out

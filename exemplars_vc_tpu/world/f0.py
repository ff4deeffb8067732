"""F0 estimation and refinement in JAX — the dio/stonemask stage.

Replaces ``pw.dio``/``pw.harvest`` + ``pw.stonemask`` (WORLD C++, used at
reference ``03_a_b_r_parallel.py:85-92``, ``04_align_n_nmf.py:404-408``).

Batched reformulation (functional equivalent, not a C port):

- Candidate stage (dio's role): normalized autocorrelation per frame, computed
  for ALL frames at once via batched rFFT (numerator) + cumulative energies
  (denominators); peak picking restricted to [sr/f0_ceil, sr/f0_floor] with
  parabolic interpolation. Voicing = peak NCC above threshold + energy gate.
- Track cleaning: 5-tap median filter + isolated-voiced removal, as fixed-size
  vector ops.
- Refinement stage (stonemask's role): per voiced frame, evaluate windowed
  DFTs on a ±6% frequency grid around the candidate (one complex matmul for
  all frames × candidates), pick the spectral peak, parabolic-refine, and
  average over harmonics 1-2 weighted by magnitude.

Everything is fixed-shape and jitted; unvoiced frames carry f0=0 exactly like
WORLD's convention.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from exemplars_vc_tpu.dsp import fft as _fft
from exemplars_vc_tpu.world.refine import flanagan_refine
import numpy as np


def _extract_segments(x: jnp.ndarray, centers: jnp.ndarray, length: int) -> jnp.ndarray:
    """Segments of ``length`` centered at each position (edge-padded)."""
    pad = length // 2
    xp = jnp.pad(x, (pad, pad), mode="edge")
    idx = centers[:, None] + jnp.arange(length)[None, :]
    return xp[idx]


def _ncc_matrix(
    x: jnp.ndarray,
    sr: int,
    frame_period_ms: float,
    f0_floor: float,
    f0_ceil: float,
    seg_len: int,
):
    """Shared NCC front-end for the DIO-role candidate pickers.

    Frames the signal, computes the per-frame normalized autocorrelation via
    one batched rFFT, masks lags outside [sr/f0_ceil, sr/f0_floor], and marks
    local maxima. Returns (ncc (F,L) unmasked, nccm (F,L) masked to −1,
    local_max (F,L) bool, total (F,1) frame energies)."""
    hop = int(round(sr * frame_period_ms / 1000.0))
    n_frames = x.shape[0] // hop + 1
    centers = jnp.arange(n_frames) * hop
    seg = _extract_segments(x, centers, seg_len)          # (F, L)
    seg = seg - jnp.mean(seg, axis=-1, keepdims=True)

    n_fft = 2 * seg_len
    magsq = _fft.rfft_magsq(seg, n=n_fft)
    ac = _fft.irfft(magsq, n=n_fft)[:, :seg_len]  # (F, L)

    # normalized: r[tau] = ac[tau] / sqrt(e0[tau] * e1[tau]) with
    # e0 = sum_{t<L-tau} x_t^2, e1 = sum_{t>=tau} x_t^2
    sq = seg * seg
    csum = jnp.cumsum(sq, axis=-1)
    total = csum[:, -1:]
    tau = jnp.arange(seg_len)
    e0 = jnp.take_along_axis(
        jnp.pad(csum, ((0, 0), (1, 0))), (seg_len - tau)[None, :].repeat(seg.shape[0], 0), axis=-1
    )
    e1 = total - jnp.take_along_axis(
        jnp.pad(csum, ((0, 0), (1, 0))), tau[None, :].repeat(seg.shape[0], 0), axis=-1
    )
    denom = jnp.sqrt(jnp.maximum(e0 * e1, 1e-12))
    ncc = ac / denom

    lag_min = jnp.int32(jnp.floor(sr / f0_ceil))
    lag_max = jnp.int32(jnp.ceil(sr / f0_floor))
    valid = (tau >= lag_min) & (tau <= jnp.minimum(lag_max, seg_len - 2))
    nccm = jnp.where(valid[None, :], ncc, -1.0)
    local_max = (
        (nccm >= jnp.pad(nccm, ((0, 0), (1, 0)))[:, :-1])
        & (nccm >= jnp.pad(nccm, ((0, 0), (0, 1)))[:, 1:])
    )
    return ncc, nccm, local_max, total


@partial(jax.jit, static_argnames=("sr", "frame_period_ms", "seg_len"))
def _ncc_candidates(
    x: jnp.ndarray,
    sr: int,
    frame_period_ms: float,
    f0_floor: float,
    f0_ceil: float,
    seg_len: int,
):
    ncc, ncc_masked, is_local_max, total = _ncc_matrix(
        x, sr, frame_period_ms, f0_floor, f0_ceil, seg_len)
    seg_len = ncc.shape[-1]
    tau = jnp.arange(seg_len)

    # subharmonic disambiguation: a periodic signal has near-equal NCC peaks
    # at every multiple of the true period — take the SMALLEST-lag local
    # maximum within 10% of the global maximum, not the global argmax.
    global_max = jnp.max(ncc_masked, axis=-1, keepdims=True)
    good = is_local_max & (ncc_masked >= 0.90 * global_max) & (global_max > 0)
    # prefer smallest tau among good candidates
    pref = jnp.where(good, (seg_len - tau)[None, :], -1)
    peak_lag = jnp.argmax(pref, axis=-1)                  # (F,)
    # frames with no good candidate fall back to the global argmax
    no_cand = jnp.max(pref, axis=-1) < 0
    peak_lag = jnp.where(no_cand, jnp.argmax(ncc_masked, axis=-1), peak_lag)
    peak_val = jnp.take_along_axis(ncc_masked, peak_lag[:, None], axis=-1)[:, 0]

    # parabolic interpolation around the integer peak
    lm1 = jnp.take_along_axis(ncc, jnp.maximum(peak_lag - 1, 0)[:, None], axis=-1)[:, 0]
    lp1 = jnp.take_along_axis(ncc, jnp.minimum(peak_lag + 1, seg_len - 1)[:, None], axis=-1)[:, 0]
    denom2 = lm1 - 2.0 * peak_val + lp1
    delta = jnp.where(jnp.abs(denom2) > 1e-9, 0.5 * (lm1 - lp1) / denom2, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    lag = peak_lag.astype(jnp.float32) + delta

    energy = total[:, 0]
    f0 = sr / jnp.maximum(lag, 1.0)
    return f0, peak_val, energy


def _median5(x: jnp.ndarray) -> jnp.ndarray:
    xp = jnp.pad(x, (2, 2), mode="edge")
    stack = jnp.stack([xp[i : i + x.shape[0]] for i in range(5)])
    return jnp.median(stack, axis=0)


@partial(jax.jit, static_argnames=("sr", "frame_period_ms", "seg_len", "n_cand"))
def _ncc_candidate_lattice(
    x: jnp.ndarray,
    sr: int,
    frame_period_ms: float,
    f0_floor: float,
    f0_ceil: float,
    seg_len: int,
    n_cand: int = 5,
):
    """Top-``n_cand`` NCC local maxima per frame → (freqs (F,C), scores (F,C))."""
    _, nccm, local_max, total = _ncc_matrix(
        x, sr, frame_period_ms, f0_floor, f0_ceil, seg_len)
    cand_scores, cand_lags = jax.lax.top_k(jnp.where(local_max, nccm, -1.0), n_cand)
    freqs = sr / jnp.maximum(cand_lags.astype(jnp.float32), 1.0)
    energy_gate = (total[:, 0] > 1e-6 * jnp.maximum(jnp.max(total), 1e-12))
    return freqs, cand_scores, energy_gate


@partial(jax.jit, static_argnames=("sr", "frame_period_ms", "seg_len", "n_cand"))
def estimate_f0_tracked(
    x: jnp.ndarray,
    sr: int = 16000,
    frame_period_ms: float = 5.0,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    seg_len: int = 512,
    n_cand: int = 5,
    voicing_threshold: float = 0.45,
    transition_weight: float = 6.0,
    voicing_switch_cost: float = 1.0,
):
    """F0 via candidate-lattice Viterbi tracking (harvest-style contour
    smoothing; the aux-kernel family of align.viterbi with per-frame
    transitions). States per frame: n_cand pitch candidates + 1 unvoiced.

    Emission: NCC score (voiced) / voicing_threshold (unvoiced).
    Transition: −transition_weight·|log f_t − log f_{t−1}| between voiced
    states, −voicing_switch_cost on voiced↔unvoiced flips. Returns
    (f0 (F,), voiced (F,))."""
    freqs, scores, energy_gate = _ncc_candidate_lattice(
        x, sr, frame_period_ms, f0_floor, f0_ceil, seg_len, n_cand
    )
    F = freqs.shape[0]
    S = n_cand + 1                      # last state = unvoiced
    logf = jnp.log(jnp.maximum(freqs, 1.0))           # (F, C)
    emit_v = jnp.where(scores > -0.5, scores, -5.0)   # (F, C)
    emit_u = jnp.full((F, 1), voicing_threshold)
    emissions = jnp.concatenate([emit_v, emit_u], axis=-1)  # (F, S)

    def step(carry, t):
        cum, ante_dummy = carry
        lf_prev, lf_now = logf[t - 1], logf[t]        # (C,)
        # voiced→voiced transition costs
        dv = jnp.abs(lf_prev[:, None] - lf_now[None, :])        # (C, C)
        trans = jnp.full((S, S), -voicing_switch_cost)
        trans = trans.at[:n_cand, :n_cand].set(-transition_weight * dv)
        trans = trans.at[n_cand, n_cand].set(0.0)
        scores_t = cum[:, None] + trans                          # (S, S)
        ante = jnp.argmax(scores_t, axis=0).astype(jnp.int32)
        cum_new = jnp.max(scores_t, axis=0) + emissions[t]
        return (cum_new, ante), ante

    init = (emissions[0], jnp.zeros((S,), jnp.int32))
    (cum_fin, _), antecedents = jax.lax.scan(step, init, jnp.arange(1, F))

    last = jnp.argmax(cum_fin).astype(jnp.int32)

    def back(state, ante_row):
        return ante_row[state], state

    first, path_rev = jax.lax.scan(back, last, antecedents[::-1])
    states = jnp.concatenate([first[None], path_rev[::-1]])      # (F,)

    picked_f0 = jnp.take_along_axis(
        freqs, jnp.clip(states, 0, n_cand - 1)[:, None], axis=-1
    )[:, 0]
    voiced = (states < n_cand) & energy_gate
    f0 = jnp.where(voiced, picked_f0, 0.0)
    f0 = jnp.where((f0 >= f0_floor) & (f0 <= f0_ceil), f0, 0.0)
    return f0, f0 > 0


@partial(jax.jit, static_argnames=("sr", "frame_period_ms", "seg_len"))
def estimate_f0(
    x: jnp.ndarray,
    sr: int = 16000,
    frame_period_ms: float = 5.0,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    voicing_threshold: float = 0.45,
    seg_len: int = 512,
):
    """Estimate the f0 contour. Returns (f0 (n_frames,), voiced mask).

    n_frames = len(x)//hop + 1, matching WORLD's frame count convention."""
    f0, ncc, energy = _ncc_candidates(
        x, sr, frame_period_ms, f0_floor, f0_ceil, seg_len
    )
    energy_gate = energy > 1e-6 * jnp.maximum(jnp.max(energy), 1e-12)
    voiced = (ncc > voicing_threshold) & energy_gate

    # median-smooth the contour over voiced runs; remove isolated voicing
    v = voiced.astype(jnp.float32)
    neighbors = jnp.pad(v, (1, 1))[:-2] + jnp.pad(v, (1, 1))[2:]
    voiced = voiced & (neighbors > 0)

    f0_smooth = _median5(jnp.where(voiced, f0, 0.0))
    f0_out = jnp.where(voiced & (f0_smooth > 0), f0_smooth, 0.0)
    f0_out = jnp.where(
        (f0_out >= f0_floor) & (f0_out <= f0_ceil), f0_out, 0.0
    )
    return f0_out, f0_out > 0


def refine_f0_stonemask(
    x: jnp.ndarray,
    f0: jnp.ndarray,
    sr: int = 16000,
    frame_period_ms: float = 5.0,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    fft_size: int | None = None,
    max_win: int | None = None,
    n_harmonics: int = 6,
):
    # window capacity must cover the 3/f0_floor Blackman window AT THIS
    # sample rate — a fixed 1024 silently truncated the window mid-support
    # for sr ≳ 24 kHz (≈45% of the segment missing at 44.1 kHz, f0 < 130 Hz)
    if max_win is None:
        max_win = 2 * int(math.ceil(3.0 * sr / f0_floor / 2.0)) + 2
    if fft_size is None:
        fft_size = int(2 ** (math.ceil(math.log2(max_win)) + 1))
    return _refine_f0_stonemask(x, f0, sr, frame_period_ms, f0_floor,
                                f0_ceil, fft_size, max_win, n_harmonics)


@partial(jax.jit, static_argnames=("sr", "frame_period_ms", "f0_floor",
                                   "f0_ceil", "fft_size", "max_win",
                                   "n_harmonics"))
def _refine_f0_stonemask(
    x: jnp.ndarray,
    f0: jnp.ndarray,
    sr: int = 16000,
    frame_period_ms: float = 5.0,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    fft_size: int = 2048,
    max_win: int = 1024,
    n_harmonics: int = 6,
):
    """WORLD StoneMask refinement (``pw.stonemask``, reference
    ``04_align_n_nmf.py:405-408``), batched — verified against the float64
    oracle in tests/oracles/world_dio.py.

    The Flanagan instantaneous-frequency estimator itself lives in
    ``world.refine.flanagan_refine`` (shared with Harvest's GetRefinedF0);
    this wrapper applies StoneMask's gates: frames refine only where the
    input f0 is voiced, and WORLD clamps the result at
    kFloorF0StoneMask = 40 Hz."""
    hop = int(round(sr * frame_period_ms / 1000.0))
    n_frames = f0.shape[0]
    centers = jnp.arange(n_frames) * hop
    x = x.astype(jnp.float32)
    cf = jnp.clip(jnp.where(f0 > 0, f0, f0_floor), f0_floor, f0_ceil)
    refined, _score, _den = flanagan_refine(
        x, cf, centers, sr, fft_size, max_win, n_harmonics)
    # WORLD gates the refinement at kFloorF0StoneMask = 40 Hz
    good = (refined >= 40.0) & (refined <= f0_ceil)
    return jnp.where((f0 > 0) & good, refined, 0.0)

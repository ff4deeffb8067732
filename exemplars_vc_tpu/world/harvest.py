"""Harvest f0 estimation in JAX (WORLD-faithful).

Replaces ``pw.harvest`` (reference ``03_a_b_r_parallel.py:87``,
``03_a_b_r.py:72-81``). Implements Harvest (Morise, INTERSPEECH 2017) with
the same algorithmic structure as the WORLD C++ sources (harvest.cpp),
verified against the float64 oracle in ``tests/oracles/world_harvest.py``:

1. 50 Hz low-cut, then a DENSE band-pass channel bank — boundary f0s at 40
   channels/octave over [0.9·floor, 1.1·ceil]; each channel filter is a
   4-period Nuttall-windowed cosine at the boundary f0 (zero-phase);
2. FOUR event-interval tracks per channel (negative/positive zero
   crossings, peaks, dips) interpolated onto the internal 1 ms grid; a
   channel yields a candidate only where their mean lies within
   [0.9, 1.1]·boundary ∩ [floor, ceil];
3. official candidates — runs of >2 adjacent agreeing channels merge to
   their mean (≤12 per frame);
4. refinement — per (frame, candidate) instantaneous-frequency analysis
   (3-period Blackman window + derivative window, Flanagan's estimator,
   amplitude-weighted over ≤6 harmonics) producing refined f0 AND a
   reliability score (inverse mean relative harmonic deviation); each
   frame's refined pool is then overlapped with its ±3 neighbors;
5. contour — best score per frame; jump removal, short-run removal,
   bidirectional candidate-pool extension; final own-frame re-refinement;
   zero-phase [¼ ½ ¼]² smoothing of voiced segments; sampled from the
   1 ms grid to the requested frame period.

Deviation from the oracle, beyond float32: the oracle's explicit
``_fix_step4_merge`` (endpoint-interpolated bridging of short unvoiced
gaps) has no separate counterpart here — the while-loop candidate-pool
extension closes the same gaps whenever the pool supports them, and the
residual disagreement is absorbed by the golden test's VUV gate
(``tests/test_golden_harvest.py``, ≥0.90 measured ≥0.94).

Static-shape discipline: the channel bank is ONE grouped ``lax.conv``
(158 channels at the default range); the four event tracks reuse DIO's
masked ordinal scatters (``world.dio._event_tracks``) with an event
capacity bounded by the channel bandwidth (crossings of a band-passed
signal cannot outpace ~1.1·f0_ceil); run-merging over the channel axis is
a cumsum/segment-sum pass; refinement batches all (frame × candidate)
windows through one static-shape rFFT pair (max_win sized by f0_floor,
masked per frame — same estimator on a finer grid, like
``world.f0.refine_f0_stonemask``); the contour fixes reuse DIO's
vectorized run-length ops and while-loop relaxation.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from exemplars_vc_tpu.world.refine import flanagan_refine
from exemplars_vc_tpu.world.dio import (
    _event_tracks,
    _extend_from_candidates,
    _fix_short_runs,
    _interp_tracks,
    _lowcut_50hz,
    _nuttall_np,
)

CHANNELS_IN_OCTAVE = 40.0
BASIC_PERIOD_MS = 1.0
OVERLAP_NEIGHBORS = 3
MAX_CANDIDATES = 12


def _bandpass_bank(sr: int, f0_floor: float, f0_ceil: float):
    """(n_ch, L) zero-phase band-pass FIRs + boundary f0s (float32)."""
    adj_floor = f0_floor * 0.9
    adj_ceil = f0_ceil * 1.1
    n_ch = 1 + int(math.log2(adj_ceil / adj_floor) * CHANNELS_IN_OCTAVE)
    boundaries = adj_floor * 2.0 ** ((1 + np.arange(n_ch)) / CHANNELS_IN_OCTAVE)
    halves = [int(np.floor(sr / b * 2.0 + 0.5)) for b in boundaries]
    L = 2 * max(halves) + 1
    bank = np.zeros((n_ch, L), np.float32)
    c = L // 2
    for i, (b, h) in enumerate(zip(boundaries, halves)):
        n = 2 * h + 1
        t = (np.arange(n) - h) / sr
        w = _nuttall_np(n) * np.cos(2.0 * np.pi * b * t)
        bank[i, c - h : c + h + 1] = w
    return bank, np.asarray(boundaries, np.float32)


def _official_candidates(raw: jnp.ndarray, max_candidates: int):
    """Merge runs (>2 long) of adjacent agreeing channels per frame.

    raw: (n_ch, F) channel candidates (0 = none) → (max_candidates, F)."""
    n_ch, F = raw.shape
    m = raw > 0.0
    prev = jnp.pad(m, ((1, 0), (0, 0)))[:-1]
    starts = m & ~prev
    run_id = jnp.cumsum(starts.astype(jnp.int32), axis=0) * m  # 0 = no run

    def per_frame(col, rid):
        sums = jax.ops.segment_sum(col, rid, num_segments=n_ch + 1)
        counts = jax.ops.segment_sum((rid > 0).astype(col.dtype) * (col > 0),
                                     rid, num_segments=n_ch + 1)
        means = sums / jnp.maximum(counts, 1.0)
        ok = counts > 2.0                       # ≥3 adjacent channels agree
        means = jnp.where(ok, means, 0.0)
        # compact the accepted runs (run ids are ascending = channel order)
        order = jnp.where(ok, jnp.arange(n_ch + 1), n_ch + 1)
        rank = jnp.argsort(order)
        packed = means[rank][:max_candidates]
        return packed

    return jax.vmap(per_frame, in_axes=(1, 1), out_axes=1)(raw, run_id)


def _refine_batch(x, cf, centers, sr, f0_floor, f0_ceil, max_win, fft_size,
                  n_harmonics=6):
    """Refine candidates cf (N,) at sample centers (N,) → (refined, score).

    Harvest's GetRefinedF0 gates around the shared Flanagan estimator
    (``world.refine.flanagan_refine``): zero candidates refine to zero, and
    results must have usable harmonics (den > 0) and land in
    [f0_floor, f0_ceil]."""
    valid = cf > 0.0
    cfs = jnp.clip(jnp.where(valid, cf, f0_floor), f0_floor, f0_ceil)
    refined, score, den = flanagan_refine(
        x, cfs, centers, sr, fft_size, max_win, n_harmonics)
    good = valid & (den > 0) & (refined >= f0_floor) & (refined <= f0_ceil)
    return jnp.where(good, refined, 0.0), jnp.where(good, score, 0.0)


def _overlap(a: jnp.ndarray, n: int) -> jnp.ndarray:
    """(C, F) → (C·(2n+1), F): each frame also sees ±n neighbors' rows."""
    outs = [a]
    for s in range(1, n + 1):
        outs.append(jnp.pad(a, ((0, 0), (s, 0)))[:, : a.shape[1]])
        outs.append(jnp.pad(a, ((0, 0), (0, s)))[:, s:])
    return jnp.concatenate(outs, axis=0)


def _smooth_voiced(f0: jnp.ndarray) -> jnp.ndarray:
    """Two zero-phase [¼ ½ ¼] passes with per-voiced-segment edge
    replication (matches the oracle's reflect-padded segment smoothing)."""
    def one(f):
        v = f > 0
        fp = jnp.pad(f, (1, 0))[:-1]
        vp = jnp.pad(v, (1, 0))[:-1]
        fn = jnp.pad(f, (0, 1))[1:]
        vn = jnp.pad(v, (0, 1))[1:]
        left = jnp.where(vp, fp, f)
        right = jnp.where(vn, fn, f)
        return jnp.where(v, 0.25 * left + 0.5 * f + 0.25 * right, 0.0)

    return one(one(f0))


@partial(jax.jit, static_argnames=("sr", "frame_period_ms", "f0_floor",
                                   "f0_ceil", "allowed_range"))
def estimate_f0_harvest(
    x: jnp.ndarray,
    sr: int = 16000,
    frame_period_ms: float = 5.0,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    allowed_range: float = 0.1,
):
    """WORLD-Harvest f0 contour. Returns (f0 (F,), voiced (F,) bool) with
    F = len(x)·1000/(sr·frame_period_ms) + 1 (WORLD's frame count)."""
    x = x.astype(jnp.float32)
    T = x.shape[0]
    F1 = int(T / sr * 1000.0 / BASIC_PERIOD_MS) + 1
    hop1 = sr * BASIC_PERIOD_MS / 1000.0
    pos1 = jnp.arange(F1, dtype=jnp.float32) * jnp.float32(hop1)   # samples

    bank, boundaries = _bandpass_bank(sr, f0_floor, f0_ceil)
    n_ch, L = bank.shape
    xh = _lowcut_50hz(x - jnp.mean(x), sr)

    pad = L // 2
    xp = jnp.pad(xh, (pad, L - 1 - pad))[None, None, :]
    filtered = jax.lax.conv_general_dilated(
        xp, jnp.asarray(bank)[:, None, :], window_strides=(1,),
        padding="VALID", dimension_numbers=("NCH", "OIH", "NCH"),
    )[0]                                                           # (n_ch, T)

    d = jnp.diff(filtered, axis=-1)
    d = jnp.concatenate([d, d[:, -1:]], axis=-1)
    sigs = jnp.concatenate([filtered, -filtered, d, -d], axis=0)   # (4C, T)
    offsets = jnp.concatenate([
        jnp.zeros(2 * n_ch), jnp.full(2 * n_ch, 0.5)
    ]).astype(jnp.float32)

    # a band-passed signal's event rate is bounded by its channel band
    # (top boundary ≈ 1.11·f0_ceil); 2× margin so noisy channels cannot
    # overflow the ordinal scatters (overflow would corrupt only that
    # channel's track, but the ±10% gate then reads garbage)
    e_max = int(T / sr * f0_ceil * 2.0) + 16
    loc, iv, count = _event_tracks(sigs, offsets, e_max)
    n_mid = jnp.maximum(count - 1, 0)
    tracks_hz = _interp_tracks(loc, iv, n_mid, pos1) * sr          # (4C, F1)
    usable = (count >= 3).reshape(4, n_ch).all(axis=0)

    tr = tracks_hz.reshape(4, n_ch, F1)
    cand = tr.mean(axis=0)                                         # (C, F1)
    b = jnp.asarray(boundaries)[:, None]
    bad = ((cand < 0.9 * b) | (cand > 1.1 * b) | (cand < f0_floor)
           | (cand > f0_ceil) | ~usable[:, None])
    raw = jnp.where(bad, 0.0, cand)

    official = _official_candidates(raw, MAX_CANDIDATES)           # (12, F1)

    # ---- refinement (one static-shape batch over candidates × frames) ----
    max_win = 2 * int(math.ceil(3.0 * sr / f0_floor / 2.0)) + 2
    fft_size = int(2 ** (math.ceil(math.log2(max_win)) + 1))
    centers1 = jnp.floor(pos1 + 0.5).astype(jnp.int32)
    # sequential lax.map over the candidate rows, NOT one flat batch: the
    # Flanagan refine materializes a (points, window) workspace, and the
    # flat 12·F1-point batch made that workspace ~4.2 GB per utterance —
    # the 7-utterance vmapped speaker program then failed AOT compilation
    # outright (29.4 GB of device memory). Mapping over the
    # 12 candidate rows divides the peak by 12 at the cost of 12 cheap
    # sequential steps; per-row math is unchanged.
    refined, score = jax.lax.map(
        lambda cf_row: _refine_batch(x, cf_row, centers1, sr, f0_floor,
                                     f0_ceil, max_win, fft_size),
        official)
    refined = _overlap(refined, OVERLAP_NEIGHBORS)
    score = _overlap(score, OVERLAP_NEIGHBORS)

    best = jnp.argmax(score, axis=0)
    f0 = jnp.take_along_axis(refined, best[None, :], 0)[0]
    f0 = jnp.where(jnp.take_along_axis(score, best[None, :], 0)[0] > 0,
                   f0, 0.0)

    # ---- contour fixes (1 ms grid) ---------------------------------------
    prev = jnp.pad(f0, (1, 0))[:-1]
    jump = (f0 > 0) & (prev > 0) & (
        jnp.abs(f0 - prev) / jnp.maximum(f0, 1e-12) > allowed_range)
    f0 = jnp.where(jump, 0.0, f0)
    vmin = int(0.5 + 1000.0 / BASIC_PERIOD_MS / f0_floor) + 1
    f0 = _fix_short_runs(f0, vmin)
    f0 = _extend_from_candidates(f0, refined, allowed_range)

    # final own-frame re-refinement of the selected contour
    f0_ref, score_ref = _refine_batch(x, f0, centers1, sr, f0_floor, f0_ceil,
                                      max_win, fft_size)
    f0 = jnp.where((f0 > 0) & (score_ref > 0), f0_ref, f0)

    f0 = _smooth_voiced(f0)

    # ---- sample the 1 ms contour at the requested period ------------------
    F = int(T / sr * 1000.0 / frame_period_ms) + 1
    q = jnp.arange(F, dtype=jnp.float32) * jnp.float32(
        frame_period_ms / BASIC_PERIOD_MS)
    idx = jnp.minimum(jnp.floor(q + 0.5).astype(jnp.int32), F1 - 1)
    out = f0[idx]
    return out, out > 0

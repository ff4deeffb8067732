"""DIO f0 estimation in JAX (WORLD-faithful).

Replaces ``pw.dio`` (reference ``03_a_b_r_parallel.py:85-92``,
``04_align_n_nmf.py:404``). Implements DIO (Morise-Kawahara-Katayose 2009)
with the same algorithmic structure as the WORLD C++ sources (dio.cpp),
verified against the float64 oracle in ``tests/oracles/world_dio.py``:

1. 50 Hz low-cut, then per channel c (boundary f0 = floor·2^((c+1)/2)) a
   zero-phase Nuttall low-pass of length 4·round(fs/boundary/2+½) (WORLD
   filters causally and shifts by the group delay; a centered FIR is the
   same operator);
2. FOUR event-interval tracks per channel — negative/positive zero
   crossings, peaks, dips — each 1/period at event midpoints, linearly
   interpolated onto the frame grid;
3. candidate = mean of the four, score = relative std; candidates outside
   [boundary/2, 2·boundary] ∪ [floor, ceil] invalid;
4. best contour = per-frame lowest score;
5. contour fixing — step 1 kills |Δf0|/f0 > allowed_range jumps, step 2
   kills voiced runs shorter than voice_range_minimum frames, steps 3/4
   re-extend voiced regions from the candidate pool.

Static-shape discipline: the channel filter bank is ONE grouped
``lax.conv``; events are extracted by sign-change masks and ordinal
scatters into fixed-size per-track arrays (no ragged lists); the
interpolation is a batched ``searchsorted``; the contour fixes are
vectorized run-length ops plus a small ``while_loop`` of whole-contour
relaxation steps (stops when the contour is stable — never unrolled).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _nuttall_np(n: int) -> np.ndarray:
    m = np.arange(n)
    return (0.355768 - 0.487396 * np.cos(2 * np.pi * m / (n - 1))
            + 0.144232 * np.cos(4 * np.pi * m / (n - 1))
            - 0.012604 * np.cos(6 * np.pi * m / (n - 1)))


def _channel_filter_bank(sr: int, f0_floor: float, f0_ceil: float,
                         channels_in_octave: float):
    """(n_bands, L_max) zero-phase Nuttall low-pass FIRs + boundary f0s."""
    n_bands = 1 + int(math.log2(f0_ceil / f0_floor) * channels_in_octave)
    boundaries = f0_floor * 2.0 ** (
        (1 + np.arange(n_bands)) / channels_in_octave
    )
    # matlab_round(fs/b/2 + 0.5) half-length, ×4 taps (WORLD nuttall length)
    lens = [int(np.floor(sr / b / 2.0 + 0.5 + 0.5)) * 4 for b in boundaries]
    L = max(lens)
    bank = np.zeros((n_bands, L), np.float32)
    for i, n in enumerate(lens):
        w = _nuttall_np(n)
        w = w / w.sum()
        start = (L - n) // 2                       # center → zero phase
        bank[i, start : start + n] = w
    return bank, np.asarray(boundaries, np.float32)


def _lowcut_50hz(x: jnp.ndarray, sr: int) -> jnp.ndarray:
    """Subtract a smooth ≤50 Hz trend (WORLD's low_cut_filter role)."""
    n = int(sr / 25) | 1
    w = jnp.asarray(np.hanning(n) / np.hanning(n).sum(), x.dtype)
    pad = n // 2
    xp = jnp.pad(x, (pad, pad), mode="edge")
    trend = jnp.convolve(xp, w, mode="valid")[: x.shape[0]]
    return x - trend


def _event_tracks(sig: jnp.ndarray, offsets: jnp.ndarray, e_max: int):
    """Batched event extraction. sig (N, T) → (loc (N, E), iv (N, E),
    count (N,)): interval midpoints (samples) and 1/period (per sample)."""
    s0, s1 = sig[:, :-1], sig[:, 1:]
    m = (s0 > 0.0) & (s1 <= 0.0)
    frac = jnp.where(m, s0 / jnp.where(m, s0 - s1, 1.0), 0.0)
    tpos = jnp.arange(sig.shape[1] - 1, dtype=sig.dtype) + frac + offsets[:, None]
    ordinal = jnp.cumsum(m, axis=-1) - 1
    idx = jnp.where(m, ordinal, e_max)
    times = jnp.zeros((sig.shape[0], e_max + 1), sig.dtype)
    times = times.at[jnp.arange(sig.shape[0])[:, None], idx].set(
        jnp.where(m, tpos, 0.0)
    )
    count = m.sum(axis=-1)
    t0, t1 = times[:, :-1], times[:, 1:]
    loc = (t0 + t1) / 2.0
    gap = t1 - t0
    iv = jnp.where(gap > 0, 1.0 / jnp.maximum(gap, 1e-6), 0.0)
    return loc, iv, count


def _interp_tracks(loc, iv, n_mid, pos):
    """np.interp semantics, batched: loc/iv (N, E) with n_mid (N,) valid
    ascending midpoints; evaluate at pos (F,)."""
    E = loc.shape[1]
    big = jnp.asarray(np.float32(1e30))
    locv = jnp.where(jnp.arange(E)[None, :] < n_mid[:, None], loc, big)

    def one(locv_i, iv_i, m_i):
        j = jnp.searchsorted(locv_i, pos)
        j = jnp.clip(j, 1, jnp.maximum(m_i - 1, 1))
        x0 = locv_i[j - 1]
        x1 = locv_i[j]
        y0 = iv_i[j - 1]
        y1 = iv_i[j]
        w = jnp.clip((pos - x0) / jnp.maximum(x1 - x0, 1e-6), 0.0, 1.0)
        return y0 + w * (y1 - y0)

    return jax.vmap(one)(locv, iv, n_mid)


def _fix_short_runs(f0, vmin):
    """Kill voiced runs shorter than vmin frames (FixStep2), vectorized."""
    F = f0.shape[0]
    v = (f0 > 0).astype(jnp.int32)
    prev = jnp.pad(v, (1, 0))[:-1]
    run_id = jnp.cumsum(v * (1 - prev) )  # 1-based id per voiced run, 0 gaps
    run_id = run_id * v                   # unvoiced frames → segment 0
    lengths = jax.ops.segment_sum(v, run_id, num_segments=F + 1)
    ok = lengths[run_id] >= vmin
    return jnp.where((v > 0) & ok, f0, 0.0)


def _extend_from_candidates(f0, cands, allowed_range):
    """FixStep3/4: grow voiced regions one frame per relaxation sweep using
    the per-frame candidate pool; stops when stable."""
    C, F = cands.shape

    def pick(ref):
        """per-frame best candidate within allowed_range of ref (F,)."""
        ok = (cands > 0) & (jnp.abs(cands - ref[None, :])
                            <= allowed_range * jnp.maximum(ref, 1e-6)[None, :])
        dist = jnp.where(ok, jnp.abs(cands - ref[None, :]), 1e30)
        best = jnp.argmin(dist, axis=0)
        val = jnp.take_along_axis(cands, best[None, :], 0)[0]
        return jnp.where(jnp.min(dist, axis=0) < 1e29, val, 0.0)

    def sweep(f0):
        left = jnp.pad(f0, (1, 0))[:-1]
        fill = pick(left)
        f0 = jnp.where((f0 == 0) & (left > 0) & (fill > 0), fill, f0)
        right = jnp.pad(f0, (0, 1))[1:]
        fill = pick(right)
        return jnp.where((f0 == 0) & (right > 0) & (fill > 0), fill, f0)

    def cond(state):
        changed, it, _ = state
        return changed & (it < F)

    def body(state):
        _, it, f0 = state
        new = sweep(f0)
        return jnp.any(new != f0), it + 1, new

    _, _, out = jax.lax.while_loop(
        cond, body, (jnp.bool_(True), jnp.int32(0), f0)
    )
    return out


@partial(jax.jit, static_argnames=("sr", "frame_period_ms", "f0_floor",
                                   "f0_ceil", "channels_in_octave",
                                   "allowed_range"))
def estimate_f0_dio(
    x: jnp.ndarray,
    sr: int = 16000,
    frame_period_ms: float = 5.0,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    channels_in_octave: float = 2.0,
    allowed_range: float = 0.1,
):
    """WORLD-DIO f0 contour. Returns (f0 (F,), voiced (F,) bool) with
    F = len(x)·1000/(sr·frame_period_ms) + 1 (WORLD's frame count)."""
    x = x.astype(jnp.float32)
    T = x.shape[0]
    hop = sr * frame_period_ms / 1000.0
    F = int(T / sr * 1000.0 / frame_period_ms) + 1
    pos = jnp.arange(F, dtype=jnp.float32) * jnp.float32(hop)  # samples

    bank, boundaries = _channel_filter_bank(sr, f0_floor, f0_ceil,
                                            channels_in_octave)
    n_bands, L = bank.shape
    xh = _lowcut_50hz(x - jnp.mean(x), sr)

    pad = L // 2
    xp = jnp.pad(xh, (pad, L - 1 - pad))[None, None, :]
    filtered = jax.lax.conv_general_dilated(
        xp, jnp.asarray(bank)[:, None, :], window_strides=(1,),
        padding="VALID", dimension_numbers=("NCH", "OIH", "NCH"),
    )[0]                                                     # (n_bands, T)

    d = jnp.diff(filtered, axis=-1)
    d = jnp.concatenate([d, d[:, -1:]], axis=-1)
    sigs = jnp.concatenate([filtered, -filtered, d, -d], axis=0)  # (4B, T)
    offsets = jnp.concatenate([
        jnp.zeros(2 * n_bands), jnp.full(2 * n_bands, 0.5)
    ]).astype(jnp.float32)

    e_max = max(T // 4, 16)
    loc, iv, count = _event_tracks(sigs, offsets, e_max)     # (4B, E)
    n_mid = jnp.maximum(count - 1, 0)
    tracks_hz = _interp_tracks(loc, iv, n_mid, pos) * sr     # (4B, F)
    usable = (count >= 3).reshape(4, n_bands).all(axis=0)    # per band

    tr = tracks_hz.reshape(4, n_bands, F)
    cand = tr.mean(axis=0)                                   # (B, F)
    score = jnp.sqrt(jnp.sum((tr - cand[None]) ** 2, axis=0) / 3.0)
    score = score / jnp.maximum(cand, 1e-12)
    b = jnp.asarray(boundaries)[:, None]
    bad = ((cand < b / 2) | (cand > b * 2) | (cand < f0_floor)
           | (cand > f0_ceil) | ~usable[:, None])
    cand = jnp.where(bad, 0.0, cand)
    score = jnp.where(bad, 1e8, score)

    best = jnp.take_along_axis(cand, jnp.argmin(score, 0)[None, :], 0)[0]

    # FixStep1: relative-jump removal (uses the ORIGINAL neighbors)
    prev = jnp.pad(best, (1, 0))[:-1]
    jump = (best > 0) & (prev > 0) & (
        jnp.abs(best - prev) / jnp.maximum(best, 1e-12) > allowed_range
    )
    f0 = jnp.where(jump, 0.0, best)
    vmin = int(0.5 + 1000.0 / frame_period_ms / f0_floor) * 2 + 1
    f0 = _fix_short_runs(f0, vmin)
    f0 = _extend_from_candidates(f0, cand, allowed_range)
    return f0, f0 > 0

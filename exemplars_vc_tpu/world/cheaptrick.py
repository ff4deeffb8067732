"""CheapTrick spectral-envelope estimation in JAX (WORLD-faithful).

Replaces ``pw.cheaptrick`` (reference ``03_a_b_r_parallel.py:94``,
``04_align_n_nmf.py:410``). Implements CheapTrick (Morise, Speech
Communication 67, 2015) with the SAME algorithmic details as the WORLD C++
sources, verified against the float64 oracle in
``tests/oracles/world_cheaptrick.py`` (golden test: tests/test_golden_world.py):

1. GetWindowedWaveform — pitch-synchronous Hanning window of length 3·T0
   (half = round(1.5·sr/f0)), edge-clamped sample gather (WORLD's
   safe_index), window normalized by √Σw², and window-weighted bias removal;
2. GetPowerSpectrum + DCCorrection — batched rFFT power; bins below f0 get
   the spectrum mirrored about f0 added;
3. LinearSmoothing — rectangular smoothing of full width 2f0/3 Hz as the
   difference of the linearly-interpolated cumulative integral of the
   mirror-extended spectrum, with WORLD's half-bin origin. The per-frame
   mirror boundary is made fixed-shape by using a static margin wide enough
   for any f0 ≤ f0_ceil (the cumulative's extra constant cancels in the
   high−low difference);
4. SmoothingWithRecovery — cosine-part cepstrum of the symmetrized log
   spectrum, × sinc smoothing lifter × q1 compensation lifter (q1 = −0.15).

Static-shape discipline: every stage is a batched gather/cumsum/rFFT over
all frames at once; per-frame data-dependent quantities (window length,
smoothing width, DC cutoff) are masks and fractional gather positions, never
dynamic shapes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from exemplars_vc_tpu.dsp import fft as _fft


DEFAULT_F0 = 500.0   # WORLD kDefaultF0 (unvoiced / below-floor frames)
Q1 = -0.15           # CheapTrick lifter coefficient
_MARGIN = 96         # static mirror margin ≥ boundary(f0_ceil) in bins
_STENCIL = 64        # static smoothing band half-width ≥ h_max + 1 bins


def world_fft_size(sr: int, f0_floor: float = 71.0) -> int:
    """WORLD's CheapTrick default: 2^(1 + floor(log2(3·sr/f0_floor + 1)))."""
    import math

    return int(2 ** (1 + int(math.log2(3.0 * sr / f0_floor + 1.0))))


def _windowed_waveform_batch(x, centers, f0, sr, max_win, periods=3.0,
                             bias_removal=True, window="hanning",
                             normalize_window=True, normalize_wave=False):
    """WORLD GetWindowedWaveform, batched over frames.

    Returns (F, max_win) segments: a ``window`` ("hanning"/"blackman") of
    length ``periods``·T0 centered at ``centers`` (sample positions, may be
    fractional), edge-clamped gather (WORLD's safe_index), optional window
    energy normalization (CheapTrick) or waveform energy normalization
    (D4C's GetCentroid), window-weighted mean removal."""
    half = jnp.floor((periods / 2.0) * sr / f0 + 0.5)          # matlab_round
    base = jnp.arange(max_win) - max_win // 2                  # (L,)
    inside = jnp.abs(base)[None, :] <= half[:, None]
    origin = jnp.floor(centers.astype(jnp.float32) + 0.001 + 0.5).astype(jnp.int32)
    idx = jnp.clip(origin[:, None] + base[None, :], 0, x.shape[0] - 1)
    seg = x[idx]                                               # (F, L)
    pos = base[None, :] / ((periods / 2.0) * sr)
    arg = jnp.pi * pos * f0[:, None]
    if window == "hanning":
        win = 0.5 * jnp.cos(arg) + 0.5
    else:                                                      # blackman
        win = 0.42 + 0.5 * jnp.cos(arg) + 0.08 * jnp.cos(2.0 * arg)
    win = win * inside
    if normalize_window:
        win = win / jnp.sqrt(jnp.sum(win * win, axis=-1, keepdims=True))
    wave = seg * win
    if bias_removal:
        coeff = jnp.sum(wave, axis=-1, keepdims=True) / jnp.sum(
            win, axis=-1, keepdims=True
        )
        wave = wave - win * coeff
    wave = wave * inside
    if normalize_wave:
        wave = wave / (jnp.sqrt(jnp.sum(wave * wave, -1, keepdims=True)) + 1e-30)
    return wave


def _dc_correction(power, f0, sr, fft_size):
    """WORLD DCCorrection: add the spectrum mirrored about f0 below f0."""
    B = power.shape[-1]
    bin_hz = sr / fft_size
    i = jnp.arange(B, dtype=power.dtype)
    q = f0[:, None] / bin_hz - i[None, :]                      # (f0 − f)/bin
    lo = jnp.clip(jnp.floor(q).astype(jnp.int32), 0, B - 2)
    frac = q - lo.astype(power.dtype)
    p_lo = jnp.take_along_axis(power, lo, axis=-1)
    p_hi = jnp.take_along_axis(power, lo + 1, axis=-1)
    replica = p_lo * (1.0 - frac) + p_hi * frac
    upper_limit_replica = (2 + (f0 * fft_size / sr).astype(jnp.int32)) - 1
    mask = jnp.arange(B)[None, :] < upper_limit_replica[:, None]
    return power + jnp.where(mask, replica, 0.0)


def _linear_smoothing(power, width_hz, sr, fft_size):
    """WORLD LinearSmoothing (width in Hz, per frame), fixed-shape.

    WORLD computes the box average as a difference of the interpolated
    cumulative integral of a mirror-extended spectrum with a half-bin origin.
    A float32 cumsum over 100+ dB of dynamic range cancels catastrophically
    (negative "power" at quiet bins), so the identical quantity is computed
    as a banded stencil instead: output bin i integrates the piecewise-
    constant extended spectrum E over the index interval
    (i − h − ½, i + h − ½] with h = width/(2·bin) — the weight of E[i+d] is
    the overlap of (d−1, d] with (−h−½, h−½], a closed form per offset d.
    Every term is nonnegative, so no cancellation; the band is a static
    ``_STENCIL`` wide (covers h for any f0 ≤ ~1000 Hz at WORLD fft sizes)."""
    B = power.shape[-1]                                        # fft//2 + 1
    bin_hz = sr / fft_size
    M = _MARGIN
    low = power[:, M:0:-1]                                     # P[|k|], k<0
    top = power[:, B - 2 : B - 2 - M : -1]                     # P[2·half − k]
    E = jnp.concatenate([low, power, top], axis=-1)            # (F, B+2M)

    h = (width_hz / (2.0 * bin_hz))[:, None]                   # (F, 1)
    out = jnp.zeros_like(power)
    for d in range(-_STENCIL, _STENCIL + 1):
        w_d = jnp.maximum(
            0.0,
            jnp.minimum(float(d), h - 0.5) - jnp.maximum(float(d - 1), -h - 0.5),
        )                                                      # (F, 1)
        out = out + w_d * jax.lax.dynamic_slice_in_dim(E, M + d, B, axis=1)
    return out * bin_hz / width_hz[:, None]


def _smoothing_with_recovery(power, f0, sr, fft_size):
    """WORLD SmoothingWithRecovery: lifter the cosine-part cepstrum."""
    B = power.shape[-1]
    log_spec = jnp.log(power)
    symmetric = jnp.concatenate([log_spec, log_spec[:, -2:0:-1]], axis=-1)
    cep = _fft.rfft(symmetric).real                            # cosine part
    tau = jnp.arange(B) / sr                                   # quefrency (s)
    arg = jnp.pi * f0[:, None] * tau[None, :]
    smoothing = jnp.where(arg > 1e-12, jnp.sin(arg) / jnp.maximum(arg, 1e-12), 1.0)
    compensation = (1.0 - 2.0 * Q1) + 2.0 * Q1 * jnp.cos(2.0 * arg)
    cep = cep * smoothing * compensation
    log_env = _fft.irfft(cep.astype(jnp.complex64), n=fft_size)[:, :B]
    return jnp.exp(jnp.clip(log_env, -80.0, 80.0))


@partial(jax.jit, static_argnames=("sr", "fft_size", "max_win"))
def cheaptrick(
    x: jnp.ndarray,
    f0: jnp.ndarray,
    centers: jnp.ndarray,
    sr: int = 16000,
    fft_size: int = 1024,
    f0_floor: float = 71.0,
    max_win: int | None = None,
) -> jnp.ndarray:
    """Spectral envelope (n_frames, fft_size//2+1), linear power scale.

    centers: per-frame sample positions. f0 ≤ f0_floor (incl. unvoiced 0)
    uses WORLD's kDefaultF0 = 500 Hz."""
    if max_win is None:
        max_win = fft_size
    x = x.astype(jnp.float32)
    f0_safe = jnp.where(f0 > f0_floor, f0, DEFAULT_F0).astype(jnp.float32)

    wave = _windowed_waveform_batch(x, centers, f0_safe, sr, max_win)
    power = _fft.rfft_magsq(wave, n=fft_size)                  # (F, B)
    power = _dc_correction(power, f0_safe, sr, fft_size)
    power = _linear_smoothing(power, f0_safe * 2.0 / 3.0, sr, fft_size)
    power = power + 1e-12          # AddInfinitesimalNoise, deterministic
    return _smoothing_with_recovery(power, f0_safe, sr, fft_size)

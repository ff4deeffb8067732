"""D4C band-aperiodicity estimation in JAX (WORLD-faithful).

Replaces ``pw.d4c`` (reference ``03_a_b_r_parallel.py:97``,
``04_align_n_nmf.py:411``). Implements D4C (Morise, Speech Communication 84,
2016) with the same algorithmic structure as the WORLD C++ sources, verified
against the float64 oracle in ``tests/oracles/world_d4c.py``:

1. LoveTrain VUV check — 3·T0 Hanning power spectrum; cumulated-power ratio
   (100, 4000] / (100, 7900] Hz; frames with f0 = 0 or ratio ≤ 0.85 stay
   fully aperiodic (1 − 1e-12);
2. static centroid — two unit-energy 4·T0 Blackman windows at ±0.25/f0;
   Re(conj(X)·FFT(t·x̂)) each, summed, DC-corrected;
3. smoothed power — 4·T0 Hanning, DC correction, width-f0 box smoothing;
4. static group delay — centroid/power, width-f0/2 smoothing, detrended by
   its width-f0 smoothing;
5. coarse aperiodicity per 3 kHz band — Nuttall-windowed group-delay
   segment, FFT, SORTED power spectrum, 10·log10 of the cumulative fraction
   outside the top ≈8-main-lobe bins; revised by min(0, ap + (f0−100)/50);
6. full band — linear interpolation in dB over [0 → −60 dB, 3 kHz bands,
   Nyquist → 0 dB], then 10^(dB/20).

Accelerator-first: every stage is batched over all frames (gathers, one rFFT per
window kind, the banded box-smoothing stencil shared with cheaptrick, one
``jnp.sort`` over the band spectra); voicing decisions are masks, not
branches. The reference grids (fft sizes, band centers, window length,
boundary) are static per sample rate.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from exemplars_vc_tpu.dsp import fft as _fft
from exemplars_vc_tpu.world.cheaptrick import (
    _dc_correction,
    _linear_smoothing,
    _windowed_waveform_batch,
)

K_FLOOR_F0_D4C = 47.0
K_LOWEST_F0_LOVE = 40.0
K_FREQ_INTERVAL = 3000.0
K_UPPER_LIMIT = 15000.0
K_THRESHOLD = 0.85
K_SAFE_MIN = 1e-12
AP_FLOOR = 0.001          # kept for callers that clamp converted aperiodicity
# WORLD's ceiling is 1 − 1e-12, which float32 rounds to exactly 1.0; use the
# closest f32 value that keeps aperiodicity strictly inside (0, 1)
AP_CEIL = 0.999999


def d4c_fft_size(sr: int) -> int:
    return int(2 ** (1 + int(math.log2(4.0 * sr / K_FLOOR_F0_D4C + 1.0))))


def _love_train_fft_size(sr: int) -> int:
    return int(2 ** (1 + int(math.log2(3.0 * sr / K_LOWEST_F0_LOVE + 1.0))))


def _n_bands(sr: int) -> int:
    return int(min(K_UPPER_LIMIT, sr / 2.0 - K_FREQ_INTERVAL) / K_FREQ_INTERVAL)


# shared 4-term Nuttall window — one definition for the D4C band windows
# and the DIO/Harvest filter banks (coefficient drift between copies would
# silently decouple the paths)
from exemplars_vc_tpu.world.dio import _nuttall_np as _nuttall  # noqa: E402


def _love_train(x, f0, centers, sr):
    """(F,) cumulated-power ratio (100,4000]/(100,7900] Hz per frame."""
    N = _love_train_fft_size(sr)
    b0 = int(np.ceil(100.0 * N / sr))
    b1 = int(np.ceil(4000.0 * N / sr))
    b2 = min(int(np.ceil(7900.0 * N / sr)), N // 2)
    f0_lt = jnp.maximum(f0, K_LOWEST_F0_LOVE)
    wave = _windowed_waveform_batch(x, centers, f0_lt, sr, N, periods=3.0,
                                    normalize_window=False)
    power = _fft.rfft_magsq(wave, n=N)
    power = power * (jnp.arange(N // 2 + 1) > b0)[None, :]
    cum = jnp.cumsum(power, axis=-1)
    return cum[:, b1] / jnp.maximum(cum[:, b2], 1e-30)


def _centroid(x, f0, centers_f, sr, fft_size, max_win):
    """Re(conj(X)·FFT(t·x̂)) with a unit-energy 4·T0 Blackman window.

    WORLD weights by the buffer index with the waveform at buffer[0:wl]
    (time origin at the WINDOW START); our wave sits centered at max_win//2.
    The origin shift Δ adds Δ·|X|² to the centroid — NOT a constant after
    dividing by the smoothed power (it carries harmonic ripple the detrend
    can't remove), so it is subtracted analytically:
    Re(conj(X)·FFT((t−Δ)·x̂)) = Re(conj(X)·FFT(t·x̂)) − Δ·|X|²."""
    wave = _windowed_waveform_batch(
        x, centers_f, f0, sr, max_win, periods=4.0, window="blackman",
        normalize_window=False, normalize_wave=True,
    )
    t = jnp.arange(max_win, dtype=wave.dtype)
    X = _fft.rfft(wave, n=fft_size)
    Y = _fft.rfft(wave * t, n=fft_size)
    half = jnp.floor(2.0 * sr / f0 + 0.5)                     # window half-len
    shift = (max_win // 2 - half)[:, None]                    # Δ per frame
    return (X.real * Y.real + X.imag * Y.imag
            - shift * (X.real * X.real + X.imag * X.imag))


def _static_group_delay(x, f0, centers, sr, fft_size, max_win):
    shift = 0.25 * sr / f0
    c1 = _centroid(x, f0, centers - shift, sr, fft_size, max_win)
    c2 = _centroid(x, f0, centers + shift, sr, fft_size, max_win)
    centroid = _dc_correction(c1 + c2, f0, sr, fft_size)

    wave = _windowed_waveform_batch(x, centers, f0, sr, max_win, periods=4.0,
                                    normalize_window=False)
    power = _fft.rfft_magsq(wave, n=fft_size)
    power = _dc_correction(power, f0, sr, fft_size)
    power = _linear_smoothing(power, f0, sr, fft_size)

    gd = centroid / jnp.maximum(power, 1e-30)
    gd = _linear_smoothing(gd, f0 / 2.0, sr, fft_size)
    return gd - _linear_smoothing(gd, f0, sr, fft_size)


def _coarse_aperiodicity(gd, f0, sr, fft_size):
    """(F, n_bands) dB estimates from sorted group-delay band spectra."""
    wl = int(K_FREQ_INTERVAL * fft_size / sr) * 2 + 1
    boundary = int(np.floor(fft_size * 8.0 / wl + 0.5))
    half = wl // 2
    window = jnp.asarray(_nuttall(wl), gd.dtype)
    nb = _n_bands(sr)
    outs = []
    for i in range(nb):
        center = int(K_FREQ_INTERVAL * (i + 1) * fft_size / sr)
        seg = gd[:, center - half : center - half + wl] * window[None, :]
        power = _fft.rfft_magsq(seg, n=fft_size)
        power = jnp.sort(power, axis=-1)
        cum = jnp.cumsum(power, axis=-1)
        ratio = cum[:, fft_size // 2 - boundary - 1] / jnp.maximum(
            cum[:, -1], 1e-30
        )
        outs.append(10.0 * jnp.log10(jnp.maximum(ratio, 1e-30)))
    coarse = jnp.stack(outs, axis=-1)
    return jnp.minimum(0.0, coarse + (f0[:, None] - 100.0) / 50.0)


@partial(jax.jit, static_argnames=("sr", "fft_size", "threshold"))
def d4c_aperiodicity(
    x: jnp.ndarray,
    f0: jnp.ndarray,
    centers: jnp.ndarray,
    sr: int = 16000,
    fft_size: int = 1024,
    threshold: float = K_THRESHOLD,
) -> jnp.ndarray:
    """Aperiodicity (n_frames, fft_size//2+1) in (0, 1).

    centers: per-frame sample positions (same convention as cheaptrick)."""
    x = x.astype(jnp.float32)
    f0 = f0.astype(jnp.float32)
    centers = centers.astype(jnp.float32)
    N = d4c_fft_size(sr)
    f0_use = jnp.maximum(f0, K_FLOOR_F0_D4C)

    ratio = _love_train(x, f0, centers, sr)
    voiced = (f0 > 0.0) & (ratio > threshold)

    # 4·T0 window at f0 ≥ 47 Hz fits in the D4C fft buffer by construction
    gd = _static_group_delay(x, f0_use, centers, sr, N, max_win=N)
    coarse = _coarse_aperiodicity(gd, f0_use, sr, N)

    nb = coarse.shape[-1]
    axis = jnp.asarray(
        np.concatenate([[0.0], K_FREQ_INTERVAL * (1 + np.arange(nb)),
                        [sr / 2.0]]), jnp.float32
    )
    B = fft_size // 2 + 1
    freqs = jnp.arange(B) * (sr / fft_size)
    lo = jnp.full((coarse.shape[0], 1), -60.0, coarse.dtype)
    hi = jnp.full((coarse.shape[0], 1), -np.float32(K_SAFE_MIN), coarse.dtype)
    vals = jnp.concatenate([lo, coarse, hi], axis=-1)
    ap_db = jax.vmap(lambda v: jnp.interp(freqs, axis, v))(vals)
    ap = jnp.clip(jnp.power(10.0, ap_db / 20.0), 1e-6, AP_CEIL)
    return jnp.where(voiced[:, None], ap, AP_CEIL)

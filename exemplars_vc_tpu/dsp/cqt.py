"""Constant-Q transform as one strided convolution against a complex kernel
bank.

Covers the constant-Q capability of the reference's vendored pyfasst TF
transforms (``dependencies/pyfasst-master/pyfasst/tftransforms/minqt.py``,
``hybridcqt.py`` — its "minimal"/hybrid CQT implementations): log-spaced
center frequencies with per-bin Q-matched window lengths. Accelerator-first design:
instead of pyfasst's per-octave FFT recursion, the whole analysis is ONE
``lax.conv`` against a precomputed (2·n_bins, max_len) cos/sin kernel bank —
framing, window and transform fused, so it runs as one dense op.

The kernel for bin k with center frequency f_k = fmin·2^(k/b) is a Hann-
windowed complex exponential of length N_k = ceil(Q·sr/f_k), Q = 1/(2^(1/b)−1),
L1-normalized (each kernel scaled by 2/N_k), centered in the max-length frame.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np


def cqt_frequencies(n_bins: int, fmin: float, bins_per_octave: int = 12) -> np.ndarray:
    return fmin * (2.0 ** (np.arange(n_bins) / bins_per_octave))


@lru_cache(maxsize=8)
def _cqt_kernel(sr: int, n_bins: int, bins_per_octave: int, fmin: float):
    """(2·n_bins, max_len) float32 cos/sin bank + max_len."""
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    if freqs[-1] > sr / 2:
        raise ValueError(
            f"top CQT bin {freqs[-1]:.1f} Hz exceeds Nyquist ({sr / 2:.1f} Hz)"
        )
    Q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    lens = np.ceil(Q * sr / freqs).astype(int)
    max_len = int(lens[0])
    kre = np.zeros((n_bins, max_len), np.float32)
    kim = np.zeros((n_bins, max_len), np.float32)
    for k, (fk, nk) in enumerate(zip(freqs, lens)):
        n = np.arange(nk)
        win = 0.5 - 0.5 * np.cos(2 * np.pi * n / nk)          # periodic hann
        phase = 2 * np.pi * fk / sr * n
        start = (max_len - nk) // 2                            # center-align
        kre[k, start : start + nk] = (win * np.cos(phase)) * (2.0 / nk)
        kim[k, start : start + nk] = (win * np.sin(phase)) * (2.0 / nk)
    return np.concatenate([kre, kim], axis=0), max_len


@partial(jax.jit, static_argnames=("sr", "hop_length", "fmin", "n_bins",
                                   "bins_per_octave"))
def cqt(
    x: jnp.ndarray,
    sr: int = 16000,
    hop_length: int = 80,
    fmin: float = 32.70319566257483,   # C1
    n_bins: int = 84,
    bins_per_octave: int = 12,
) -> jnp.ndarray:
    """Constant-Q spectrogram of ``x`` (..., T) → complex (..., frames, n_bins).

    Frames are taken every ``hop_length`` samples with the signal reflect-
    padded by half the longest kernel (center-aligned analysis, librosa-like).
    """
    kernel_np, max_len = _cqt_kernel(sr, n_bins, bins_per_octave, float(fmin))
    lead = x.shape[:-1]
    pad = [(0, 0)] * (x.ndim - 1) + [(max_len // 2, max_len // 2)]
    xp = jnp.pad(x.astype(jnp.float32), pad, mode="reflect")
    xb = xp.reshape((-1, 1, xp.shape[-1]))
    kernel = jnp.asarray(kernel_np)[:, None, :]                # (2K, 1, L)
    out = jax.lax.conv_general_dilated(
        xb, kernel, window_strides=(hop_length,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
    )                                                          # (N, 2K, F)
    re = jnp.moveaxis(out[:, :n_bins, :], 1, 2)
    im = jnp.moveaxis(out[:, n_bins:, :], 1, 2)
    return jax.lax.complex(re, -im).reshape(lead + re.shape[1:])


def cqt_magnitude(x: jnp.ndarray, **kw) -> jnp.ndarray:
    return jnp.abs(cqt(x, **kw))


def hybrid_cqt(
    x: jnp.ndarray,
    sr: int = 16000,
    hop_length: int = 80,
    fmin: float = 32.70319566257483,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    n_fft: int = 400,
) -> tuple[jnp.ndarray, jnp.ndarray, np.ndarray]:
    """Hybrid constant-Q + linear-frequency analysis.

    The capability of pyfasst's ``HybridCQTKernel``/``MinQTKernel``
    (``tftransforms/hybridcqt.py:180-339`` — a CQT whose kernel is completed
    with "missing" linear-frequency bins above the top CQ band): constant-Q
    bins up to the top CQ center frequency, then the STFT's linear bins for
    the remaining spectrum, both on the same hop grid. Returns
    ``(cq_coeffs (..., frames, n_bins), lin_coeffs (..., frames, n_lin),
    lin_freqs_hz)``; frame counts are aligned by truncation to the shorter.
    """
    from exemplars_vc_tpu.dsp.stft import stft

    cq = cqt(x, sr=sr, hop_length=hop_length, fmin=fmin, n_bins=n_bins,
             bins_per_octave=bins_per_octave)
    f_top = float(cqt_frequencies(n_bins, fmin, bins_per_octave)[-1])
    spec = stft(x, n_fft=n_fft, hop_length=hop_length)     # (..., frames, bins)
    lin_freqs = np.arange(n_fft // 2 + 1) * sr / n_fft
    k0 = int(np.searchsorted(lin_freqs, f_top, side="right"))
    n = min(cq.shape[-2], spec.shape[-2])
    return cq[..., :n, :], spec[..., :n, k0:], lin_freqs[k0:]

"""Mel filterbank, mel spectrogram, and MFCC as jitted JAX ops.

Replaces ``librosa.feature.mfcc(n_fft=400, hop_length=80/160)`` used to build
the alignment features (``01_make_dict_parallel.py:101``) and the hand-rolled
filterbank in ``zz_audio_utilities.py:81-178``. Semantics follow librosa's
defaults of that era: Slaney mel scale (htk=False), slaney area-normalized
triangular filters, power spectrogram, power→dB with top_db=80, orthonormal
DCT-II. All of it is matmuls + elementwise → friendly to any accelerator.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from exemplars_vc_tpu.dsp.stft import stft


def hz_to_mel(f, htk: bool = False):
    f = np.asanyarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, logarithmic above.
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log_branch = min_log_mel + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_branch, mel)


def mel_to_hz(m, htk: bool = False):
    m = np.asanyarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_min + f_sp * m)


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
) -> np.ndarray:
    """(n_mels, n_fft//2+1) triangular filterbank (numpy; build once, jit-close over)."""
    fmax = fmax or sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm[:, None]
    return fb.astype(np.float32)


def dct_matrix(n_out: int, n_in: int, dtype=np.float32) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_out, n_in) — scipy.fft.dct(type=2, norm='ortho')."""
    k = np.arange(n_out, dtype=np.float64)[:, None]
    n = np.arange(n_in, dtype=np.float64)[None, :]
    m = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in)) * np.sqrt(2.0 / n_in)
    m[0] /= np.sqrt(2.0)
    return m.astype(dtype)


def power_to_db(S: jnp.ndarray, amin: float = 1e-10, top_db: float | None = 80.0) -> jnp.ndarray:
    log_spec = 10.0 * jnp.log10(jnp.maximum(amin, S))
    if top_db is not None:
        log_spec = jnp.maximum(log_spec, jnp.max(log_spec) - top_db)
    return log_spec


@partial(jax.jit, static_argnames=("sr", "n_fft", "hop_length", "n_mels", "power"))
def melspectrogram(
    x: jnp.ndarray,
    sr: int = 16000,
    n_fft: int = 400,
    hop_length: int = 80,
    n_mels: int = 128,
    power: float = 2.0,
) -> jnp.ndarray:
    """(T,) → (n_frames, n_mels) mel power spectrogram (frames-major)."""
    mag = jnp.abs(stft(x, n_fft=n_fft, hop_length=hop_length)) ** power
    fb = jnp.asarray(mel_filterbank(sr, n_fft, n_mels))
    return mag @ fb.T


@partial(jax.jit, static_argnames=("sr", "n_fft", "hop_length", "n_mfcc", "n_mels"))
def mfcc(
    x: jnp.ndarray,
    sr: int = 16000,
    n_fft: int = 400,
    hop_length: int = 80,
    n_mfcc: int = 20,
    n_mels: int = 128,
) -> jnp.ndarray:
    """(T,) → (n_frames, n_mfcc), librosa.feature.mfcc semantics, frames-major.

    The reference calls this with default n_mfcc=20 to build the DTW/warping
    features (``01_make_dict_parallel.py:101,358``)."""
    S = melspectrogram(x, sr=sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels)
    S_db = power_to_db(S)
    D = jnp.asarray(dct_matrix(n_mfcc, n_mels))
    return S_db @ D.T

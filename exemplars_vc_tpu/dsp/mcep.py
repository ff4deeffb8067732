"""Mel-cepstral analysis as a batched Newton solver of matmuls.

Replaces ``pysptk.mcep`` (C SPTK, called per frame through
``np.apply_along_axis`` at reference ``01_make_dict_parallel.py:126-129`` with
order=25, alpha=0.42, blackman(400) windowing). SPTK's mcep implements
mel-cepstral analysis (Fukada et al., ICASSP 1992): minimize the spectral
criterion  E = (1/2π)∫ [exp R(ω) − R(ω) − 1] dω  with
R(ω) = log I(ω) − 2·Σ_m c_m cos(m·ω̃(ω)),  where ω̃ is the all-pass–warped
frequency with warping factor α.

Batched reformulation: instead of SPTK's per-frame recursive FFT machinery,
we evaluate the warped cosine basis Φ[n,m] = cos(m·ω̃(ω_n)) once on the FFT
grid and express every Newton step as dense batched matmuls over frames
(gradient = Φᵀ·weighted residual, Hessian = ΦᵀWΦ per frame) + a batched
(order+1)² Cholesky solve — all matmul work, vmapped over thousands of frames at
once. The solution is the stationary point of the same criterion SPTK solves.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from exemplars_vc_tpu.dsp import fft as _fft
import numpy as np


def warped_phase(omega: np.ndarray, alpha: float) -> np.ndarray:
    """Phase response ω̃(ω) of the all-pass z̃⁻¹ = (z⁻¹ − α)/(1 − α z⁻¹)."""
    return omega + 2.0 * np.arctan2(alpha * np.sin(omega), 1.0 - alpha * np.cos(omega))


def warped_basis(n_bins: int, order: int, alpha: float) -> np.ndarray:
    """(n_bins, order+1) basis Φ[n,m] = cos(m·ω̃(ω_n)), ω_n = πn/(n_bins−1)."""
    omega = np.linspace(0.0, np.pi, n_bins)
    wt = warped_phase(omega, alpha)
    return np.cos(np.outer(wt, np.arange(order + 1))).astype(np.float64)


def _quad_weights(n_bins: int) -> np.ndarray:
    w = np.ones(n_bins)
    w[0] = w[-1] = 0.5  # trapezoid endpoints on [0, π]
    return w


@partial(jax.jit, static_argnames=("order", "alpha", "n_iter"))
def mcep_from_log_periodogram(
    log_I: jnp.ndarray, order: int = 25, alpha: float = 0.42, n_iter: int = 10
) -> jnp.ndarray:
    """Batched mel-cepstrum from log periodograms.

    log_I: (..., n_bins) log power spectrum on the [0, π] half grid.
    Returns (..., order+1) mel-cepstra c with log|D(ω)| = Σ c_m cos(m ω̃).
    """
    n_bins = log_I.shape[-1]
    phi = jnp.asarray(warped_basis(n_bins, order, alpha), dtype=log_I.dtype)
    w = jnp.asarray(_quad_weights(n_bins), dtype=log_I.dtype)

    # Weighted least-squares init: 2Φc ≈ log I  (warped-cepstral smoothing).
    phiw = phi * w[:, None]
    gram = phi.T @ phiw
    proj = jnp.linalg.solve(gram, phiw.T)           # (M+1, n_bins)
    c = 0.5 * (log_I @ proj.T)

    def newton_step(c, _):
        s2 = 2.0 * (c @ phi.T)                      # log |D|² on the grid
        R = jnp.clip(log_I - s2, -60.0, 30.0)
        eR = jnp.exp(R)
        # ∂E/∂c = −2 Φᵀ (w ⊙ (e^R − 1));  ∂²E/∂c² = 4 Φᵀ diag(w e^R) Φ
        g = -2.0 * ((w * (eR - 1.0)) @ phi)
        H = 4.0 * jnp.einsum("...n,nm,nk->...mk", w * eR, phi, phi)
        delta = jnp.linalg.solve(H, -g[..., None])[..., 0]
        return c + delta, None

    c, _ = jax.lax.scan(newton_step, c, None, length=n_iter)
    return c


@partial(jax.jit, static_argnames=("order", "alpha", "n_fft", "n_iter"))
def mcep_frames(
    frames: jnp.ndarray,
    order: int = 25,
    alpha: float = 0.42,
    n_fft: int = 512,
    n_iter: int = 10,
    eps: float = 1e-8,
) -> jnp.ndarray:
    """Windowed frames (..., frame_length) → mel-cepstra (..., order+1).

    The caller applies the analysis window (the reference multiplies frames by
    ``pysptk.blackman(400)`` before calling mcep)."""
    spec = _fft.rfft_magsq(frames, n=n_fft)
    floor = eps * jnp.max(spec, axis=-1, keepdims=True) + 1e-30
    return mcep_from_log_periodogram(
        jnp.log(jnp.maximum(spec, floor)), order=order, alpha=alpha, n_iter=n_iter
    )


def mcep(
    x: jnp.ndarray,
    frame_length: int = 400,
    hop_length: int = 80,
    order: int = 25,
    alpha: float = 0.42,
    window: str = "blackman",
    n_fft: int = 512,
    n_iter: int = 10,
) -> jnp.ndarray:
    """Whole-utterance mel-cepstrogram (n_frames, order+1), frames-major.

    End-to-end equivalent of the reference's frame→blackman→mcep chain
    (``01_make_dict_parallel.py:126-129``) in one jitted call."""
    from exemplars_vc_tpu.dsp.stft import frame_signal
    from exemplars_vc_tpu.dsp.windows import get_window

    frames = frame_signal(x, frame_length, hop_length)
    frames = frames * get_window(window, frame_length, periodic=False, dtype=frames.dtype)
    return mcep_frames(frames, order=order, alpha=alpha, n_fft=n_fft, n_iter=n_iter)


@partial(jax.jit, static_argnames=("n_bins", "alpha"))
def mcep_to_spectrum(c: jnp.ndarray, n_bins: int = 257, alpha: float = 0.42) -> jnp.ndarray:
    """Mel-cepstra (..., order+1) → linear power spectrum |D(ω)|² on (..., n_bins)."""
    order = c.shape[-1] - 1
    phi = jnp.asarray(warped_basis(n_bins, order, alpha), dtype=c.dtype)
    return jnp.exp(2.0 * (c @ phi.T))

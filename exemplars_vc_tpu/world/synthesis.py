"""WORLD-class synthesis in JAX: harmonic + shaped-noise model.

Replaces ``pw.synthesize`` (reference ``04_align_n_nmf.py:176``,
``05_conversion.py``-era usage). WORLD synthesizes pulse-by-pulse with
minimum-phase responses — inherently sequential in the pulse positions.
accelerator-first alternative with the same inputs (f0, spectral envelope sp,
aperiodicity ap): harmonic additive synthesis.

- per-sample phase φ[t] = 2π·cumsum(f0↑)/sr (one scan-free cumsum),
- harmonic amplitudes a_k[t] = √(4·sp(k·f0)·f0/sr)·√(1 − ap(k·f0)²),
  gathered by one interpolated lookup per harmonic and upsampled linearly
  in time (the 4·…/sr constant is calibrated analyzer-consistent — see the
  inline note and the analyzer-consistency measurement),
- periodic part y_p[t] = Σ_k a_k[t]·cos(k·φ[t]) — a (T × K) elementwise
  block summed over K (all-cosine sum ⇒ pulse-train-like excitation shaped
  by the envelope, zero-phase),
- noise part: white noise STFT-shaped by √(sp)·ap and inverted with the
  framework ISTFT.

Fully jitted, fixed shapes, no per-pulse control flow.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from exemplars_vc_tpu.dsp.stft import istft, stft


def _upsample_frames(values: jnp.ndarray, hop: int, n_samples: int) -> jnp.ndarray:
    """(F, ...) frame values → (T, ...) per-sample by linear interpolation."""
    F = values.shape[0]
    t = jnp.arange(n_samples) / hop
    lo = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, F - 1)
    hi = jnp.clip(lo + 1, 0, F - 1)
    frac = (t - lo).reshape((-1,) + (1,) * (values.ndim - 1))
    return values[lo] * (1.0 - frac) + values[hi] * frac


@partial(jax.jit, static_argnames=("sr", "frame_period_ms", "fft_size", "max_harmonics"))
def synthesize(
    f0: jnp.ndarray,
    sp: jnp.ndarray,
    ap: jnp.ndarray,
    sr: int = 16000,
    frame_period_ms: float = 5.0,
    fft_size: int = 1024,
    max_harmonics: int = 96,
    key: jax.Array | None = None,
) -> jnp.ndarray:
    """f0 (F,), sp (F, B), ap (F, B) → waveform ((F−1)·hop,)."""
    hop = int(round(sr * frame_period_ms / 1000.0))
    F, B = sp.shape
    n_samples = (F - 1) * hop
    if key is None:
        key = jax.random.PRNGKey(0)

    voiced = (f0 > 0).astype(sp.dtype)
    f0_safe = jnp.where(f0 > 0, f0, 150.0)

    # ---- periodic component -------------------------------------------------
    f0_t = _upsample_frames(f0_safe, hop, n_samples)            # (T,)
    voiced_t = _upsample_frames(voiced, hop, n_samples)
    phase = 2.0 * jnp.pi * jnp.cumsum(f0_t) / sr                # (T,)

    k = jnp.arange(1, max_harmonics + 1, dtype=sp.dtype)        # (K,)
    bin_hz = sr / fft_size
    # per-frame harmonic amplitudes: interp sp/ap at k·f0
    harm_hz = f0_safe[:, None] * k[None, :]                     # (F, K)
    pos = jnp.clip(harm_hz / bin_hz, 0.0, B - 1.001)
    lo = jnp.floor(pos).astype(jnp.int32)
    frac = pos - lo
    sp_k = jnp.take_along_axis(sp, lo, 1) * (1 - frac) + jnp.take_along_axis(
        sp, jnp.minimum(lo + 1, B - 1), 1) * frac
    ap_k = jnp.take_along_axis(ap, lo, 1) * (1 - frac) + jnp.take_along_axis(
        ap, jnp.minimum(lo + 1, B - 1), 1) * frac
    nyq_mask = (harm_hz < 0.495 * sr).astype(sp.dtype)
    # analyzer-consistent harmonic gain, calibrated against THIS framework's
    # CheapTrick: a pure harmonic series with a_k² = 4·sp(k·f0)·f0/sr
    # re-analyzes to the same sp (measured flat to <0.3 dB; with the 2.0
    # constant the round trip sat 3 dB low across all bands)
    amp = jnp.sqrt(jnp.maximum(4.0 * sp_k * f0_safe[:, None] / sr, 0.0))
    # WORLD's energy partition: periodic POWER fraction is 1 − ap², noise
    # power fraction ap² — amplitude scales by sqrt(1 − ap²), not (1 − ap)
    amp = amp * jnp.sqrt(jnp.maximum(1.0 - ap_k * ap_k, 0.0)) \
        * nyq_mask * voiced[:, None]                            # (F, K)

    # minimum-phase harmonic phases from the envelope cepstrum: for a
    # minimum-phase system, arg H(ω) = −Σ_{τ>0} 2·c_τ·sin(ωτ) with c the real
    # cepstrum of ½·log sp — WORLD likewise excites minimum-phase responses
    # rather than zero-phase pulses (less buzzy, natural phase dispersion)
    n_ceps = 64
    log_half = 0.5 * jnp.log(jnp.maximum(sp, 1e-20))
    from exemplars_vc_tpu.dsp import fft as _fft

    # real cepstrum: irfft of the half log-spectrum (real, symmetric)
    ceps = _fft.irfft(log_half, n=2 * (B - 1))[:, 1:n_ceps]      # (F, n_ceps-1)
    tau = jnp.arange(1, n_ceps, dtype=sp.dtype)                  # (τ,)
    omega_k = 2.0 * jnp.pi * harm_hz / sr                        # (F, K)
    sin_basis = jnp.sin(omega_k[:, :, None] * tau[None, None, :])
    theta = -2.0 * jnp.einsum("ft,fkt->fk", ceps, sin_basis)     # (F, K)

    amp_t = _upsample_frames(amp, hop, n_samples)               # (T, K)
    theta_t = _upsample_frames(theta, hop, n_samples)
    y_per = jnp.sum(amp_t * jnp.cos(phase[:, None] * k[None, :] + theta_t), axis=-1)
    y_per = y_per * voiced_t

    # ---- aperiodic component ------------------------------------------------
    noise = jax.random.normal(key, (n_samples,), dtype=sp.dtype)
    N = stft(noise, n_fft=fft_size, hop_length=hop, window="hann")
    Fn = min(N.shape[0], F)
    # shape noise by √(sp·psd-correction)·ap; white noise has flat PSD of 1
    shape = jnp.sqrt(jnp.maximum(sp[:Fn], 0.0)) * ap[:Fn]
    N = N[:Fn] * shape
    y_ap = istft(N, n_fft=fft_size, hop_length=hop, window="hann", length=n_samples)

    return y_per + y_ap

"""Jitted complex-STFT glue shared by the separation entry points.

Outside ``jit`` every op is dispatched as its own tiny XLA program. Every
separation pipeline therefore routes its complex glue — STFT stacking,
Wiener mask application, source-image ISTFT, spatial-covariance
construction — through these jitted helpers, one compiled program per step;
the model fits themselves are single jitted programs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from exemplars_vc_tpu.dsp.stft import istft, stft

_EPS = 1e-12


@partial(jax.jit, static_argnames=("n_fft", "hop_length", "fnc"))
def stft_stack(x: jnp.ndarray, n_fft: int, hop_length: int,
               fnc: bool = True) -> jnp.ndarray:
    """Multichannel STFT, stacked (F, N, C) [``fnc``] or (C, F, N)."""
    S = stft(x, n_fft=n_fft, hop_length=hop_length)      # (C, frames, bins)
    return jnp.transpose(S, (2, 1, 0) if fnc else (0, 2, 1))


def _host_stft_power(x, n_fft: int, hop_length: int):
    """Float64 HOST power spectrogram with ``dsp.stft``'s exact semantics
    (center reflect-pad, periodic hann) — (..., F, N).

    The SIMM-family fits minimize the IS divergence, which weights every
    bin equally; float32 device STFTs differ across platforms by ~1e-9 of
    the mean power in near-silent bins, and those differences steer the
    damped multiplicative updates chaotically (measured: swapping in the
    other platform's spectrogram reproduces its trajectory exactly —
    measured). The reference's pyfasst computes its STFT
    power host-side in float64 for the same reason
    (``SeparateLeadStereo/SeparateLeadStereoTF.py``, host numpy); this
    helper is that design decision kept: the cheap spectrogram in f64 on
    host, the 40-iteration fit on device.
    """
    import numpy as np

    P = np.abs(_host_stft(x, n_fft, hop_length)) ** 2  # (..., N, F)
    return np.swapaxes(P, -1, -2)                      # (..., F, N)


def _host_stft(x, n_fft: int, hop_length: int):
    """Float64 host STFT with ``dsp.stft``'s exact semantics — complex128
    (..., N, F). See ``_host_stft_power`` for why host-side."""
    import numpy as np

    x = np.asarray(x, np.float64)
    pad = [(0, 0)] * (x.ndim - 1) + [(n_fft // 2, n_fft // 2)]
    x = np.pad(x, pad, mode="reflect")
    n_frames = 1 + (x.shape[-1] - n_fft) // hop_length
    idx = (np.arange(n_fft)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    t = 2.0 * np.pi * np.arange(n_fft) / n_fft
    w = 0.5 - 0.5 * np.cos(t)
    return np.fft.rfft(x[..., idx] * w, axis=-1)      # (..., N, F)


@partial(jax.jit, static_argnames=("fnc",))
def _combine_stft(re: jnp.ndarray, im: jnp.ndarray, fnc: bool):
    # complex construction inside one jitted program
    S = re + 1j * im                                   # (C, N, F)
    return jnp.transpose(S, (2, 1, 0) if fnc else (0, 2, 1))


def host_stft_stack(x, n_fft: int, hop_length: int,
                    fnc: bool = True) -> jnp.ndarray:
    """Platform-exact multichannel STFT: float64 host computation, rounded
    to float32 parts, combined to complex64 ON DEVICE. Layout matches
    ``stft_stack``: (F, N, C) [``fnc``] or (C, F, N). x: (C, T) audio.

    Separation entry points use this for BOTH the model-input power and
    the masked-synthesis STFT so the fits and the output images are
    platform-reproducible end-to-end (the IS-family EMs amplify device
    STFT roundoff chaotically — measured)."""
    import numpy as np

    S = _host_stft(x, n_fft, hop_length)              # (C, N, F) complex128
    return _combine_stft(jnp.asarray(S.real.astype(np.float32)),
                         jnp.asarray(S.imag.astype(np.float32)), fnc)


def host_stereo_powers(x, n_fft: int, hop_length: int):
    """Unit-mean per-channel power spectra (R, L), computed host-side in
    float64 and returned as float32 numpy (platform-exact SIMM input; see
    ``_host_stft_power``). x: (C, T) audio."""
    import numpy as np

    P = _host_stft_power(x, n_fft, hop_length)        # (C, F, N)
    SXR = np.maximum(P[0], _EPS)
    SXL = np.maximum(P[-1], _EPS)
    scale = max(0.5 * (SXR.mean() + SXL.mean()), _EPS)
    return ((SXR / scale).astype(np.float32),
            (SXL / scale).astype(np.float32))


def host_mean_power(x, n_fft: int, hop_length: int):
    """Channel-mean power spectrum (F, N), float64 host computation,
    float32 numpy out. x: (C, T)."""
    import numpy as np

    P = _host_stft_power(x, n_fft, hop_length).mean(axis=0)
    return np.maximum(P, _EPS).astype(np.float32)


@jax.jit
def stereo_powers(X_cfn: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Unit-mean per-channel power spectra (R, L) from a (C, F, N) STFT.

    DEVICE-side variant — fine for scale estimation, but the SIMM-family
    entry points use ``host_stereo_powers`` instead: the IS-divergence fit
    is chaotically sensitive to the platform roundoff of near-silent bins
    (measured)."""
    SXR = jnp.maximum(jnp.abs(X_cfn[0]) ** 2, _EPS)
    SXL = jnp.maximum(jnp.abs(X_cfn[-1]) ** 2, _EPS)
    scale = jnp.maximum(0.5 * (jnp.mean(SXR) + jnp.mean(SXL)), _EPS)
    return SXR / scale, SXL / scale


@jax.jit
def mean_power(X_fnc: jnp.ndarray) -> jnp.ndarray:
    """Channel-mean power spectrum (F, N) of a (F, N, C) STFT (device-side
    variant; SIMM-family entry points use ``host_mean_power``)."""
    return jnp.maximum(jnp.mean(jnp.abs(X_fnc) ** 2, axis=-1), _EPS)


@partial(jax.jit, static_argnames=("n_fft", "hop_length", "length", "fnc"))
def masked_istft(X: jnp.ndarray, gain: jnp.ndarray, n_fft: int,
                 hop_length: int, length: int, fnc: bool = True):
    """Wiener-style split: (X·gain, X − X·gain) → two (C, T) signals.

    X: (F, N, C) [``fnc``] or (C, F, N) complex STFT; gain broadcastable
    to X (real)."""
    lead_spec = X * gain
    acc_spec = X - lead_spec

    def synth(spec):
        s = jnp.transpose(spec, (2, 1, 0) if fnc else (0, 2, 1))
        return jax.vmap(
            lambda m: istft(m, n_fft=n_fft, hop_length=hop_length,
                            length=length)
        )(s)

    return synth(lead_spec), synth(acc_spec)


@partial(jax.jit, static_argnames=("n_fft", "hop_length", "length"))
def images_istft(Y: jnp.ndarray, n_fft: int, hop_length: int,
                 length: int) -> jnp.ndarray:
    """Source-image STFTs Y (J, F, N, C) → time-domain images (J, C, T)."""
    specs = jnp.transpose(Y, (0, 3, 2, 1))               # (J, C, frames, bins)
    flat = specs.reshape((-1,) + specs.shape[2:])
    audio = jax.vmap(
        lambda s: istft(s, n_fft=n_fft, hop_length=hop_length, length=length)
    )(flat)
    return audio.reshape(Y.shape[0], Y.shape[3], length)


@partial(jax.jit, static_argnames=("n_fft", "hop_length", "diffuse"))
def empirical_spatial_cov(img: jnp.ndarray, n_fft: int, hop_length: int,
                          diffuse: float = 0.05) -> jnp.ndarray:
    """Trace-normalized empirical spatial covariance (F, C, C) of a signal,
    mixed with ``diffuse``·I so EM can move from it."""
    X = stft_stack(img, n_fft, hop_length, fnc=True)     # (F, N, C)
    C = X.shape[-1]
    XX = X[..., :, None] * jnp.conj(X)[..., None, :]
    Rf = XX.mean(axis=1)                                  # (F, C, C)
    tr = jnp.maximum(jnp.real(jnp.trace(Rf, axis1=-2, axis2=-1)), _EPS)
    Rf = Rf * (C / tr)[..., None, None]
    eye = jnp.eye(C, dtype=jnp.complex64)
    return (1.0 - diffuse) * Rf + diffuse * eye


@jax.jit
def steering_to_spatial(a: jnp.ndarray, diffuse: float = 0.05) -> jnp.ndarray:
    """Rank-1-plus-diffuse spatial covariances (J, F, C, C) from steering
    vectors a (J, F, C)."""
    aaH = a[..., :, None] * jnp.conj(a)[..., None, :]
    tr = jnp.maximum(jnp.real(jnp.trace(aaH, axis1=-2, axis2=-1)), _EPS)
    C = a.shape[-1]
    aaH = aaH * (C / tr)[..., None, None]
    eye = jnp.eye(C, dtype=jnp.complex64)
    return ((1.0 - diffuse) * aaH + diffuse * eye).astype(jnp.complex64)


@jax.jit
def anechoic_steering(theta: jnp.ndarray, delay: jnp.ndarray,
                      freqs: jnp.ndarray) -> jnp.ndarray:
    """a_j(f) = [cosθ_j, sinθ_j·e^{−i2πfδ_j}] — (J, F, 2) complex64."""
    th = theta[:, None]
    dl = delay[:, None]
    phase = jnp.exp(-2j * jnp.pi * freqs[None, :] * dl)
    a0 = jnp.broadcast_to(jnp.cos(th), phase.shape).astype(jnp.complex64)
    a1 = (jnp.sin(th) * phase).astype(jnp.complex64)
    return jnp.stack([a0, a1], axis=-1)


@jax.jit
def unit_power(X: jnp.ndarray) -> jnp.ndarray:
    """X / sqrt(mean |X|²) — unit-mean-power complex STFT.

    The separation models are scale-covariant and their Wiener masks
    scale-INVARIANT, but float32 factor chains overflow on raw power
    values; fitting on the normalized STFT keeps every factor O(1) (and
    keeps the composed source-F0-filter fit consistent with its SIMM seeds,
    which are estimated from unit-mean power spectra)."""
    s = jnp.maximum(jnp.mean(jnp.abs(X) ** 2), _EPS)
    return X / jnp.sqrt(s)


@jax.jit
def first_source(R: jnp.ndarray) -> jnp.ndarray:
    """R[0] — jitted because even eager complex SLICING is unimplemented."""
    return R[0]


@partial(jax.jit, static_argnames=("n_copies",))
def stack_spatial(R_lead: jnp.ndarray, R_acc: jnp.ndarray,
                  n_copies: int) -> jnp.ndarray:
    """[R_lead; R_acc × n_copies] — (1 + n_copies, F, C, C) complex."""
    return jnp.concatenate(
        [R_lead[None], jnp.broadcast_to(R_acc[None],
                                        (n_copies,) + R_acc.shape)])

"""Spatial beamforming: ULA steering vectors, MVDR filters, directivity
diagrams.

Covers the reference's vendored pyfasst spatial toolbox
(``dependencies/pyfasst-master/pyfasst/spatial/dirdiag.py`` —
``make_MVDR_filter_target`` :20, ``generate_steer_vec_thetas`` :207,
``directivity_filter_diagram_ULA`` :71 — and
``spatial/steering_vectors.py``). Accelerator-first design: the reference computes
per-frequency 2×2 inverses in a numpy loop and draws matplotlib figures; here
steering-vector banks, covariance builds, MVDR solves, and angle×frequency
response surfaces are all batched closed-form ops (the directivity "diagram"
is returned as a dB array — plotting is the caller's concern). The C=2
Hermitian inverse reuses the same closed-form kernel as the FASST EM
(``separate/multichannel.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from exemplars_vc_tpu.separate.multichannel import _inv_hermitian

SOUND_SPEED = 340.0  # m/s


def ula_steering(
    thetas: jnp.ndarray,
    freqs: jnp.ndarray,
    n_sensors: int = 2,
    dist_inter_sensor: float = 0.15,
    sound_speed: float = SOUND_SPEED,
) -> jnp.ndarray:
    """Anechoic far-field steering vectors for a uniform linear array.

    a_m(f, θ) = exp(−2πi·f·m·d·sin(θ)/c) for sensor m — (n_thetas, F, C)
    complex64 (≙ ``dirdiag.generate_steer_vec_thetas``).
    """
    thetas = jnp.atleast_1d(jnp.asarray(thetas, jnp.float32))
    freqs = jnp.atleast_1d(jnp.asarray(freqs, jnp.float32))
    m = jnp.arange(n_sensors, dtype=jnp.float32)
    delay = dist_inter_sensor / sound_speed * jnp.sin(thetas)        # (T,)
    phase = -2.0 * jnp.pi * delay[:, None, None] * freqs[None, :, None] * m
    return jax.lax.complex(jnp.cos(phase), jnp.sin(phase))


def mvdr_filter(
    steer_target: jnp.ndarray,
    steer_interf: jnp.ndarray | None = None,
    diag_load: float = 1e-3,
) -> jnp.ndarray:
    """Distortionless MVDR beamformer from steering vectors.

    ``steer_target`` (F, C); ``steer_interf`` (J, F, C) or None. Builds the
    rank-1 interference-plus-target covariance R(f) = Σ a aᴴ + δI (the same
    construction as ``dirdiag.make_MVDR_filter_target`` :20-69, generalized
    beyond stereo) and returns w(f) = R⁻¹a_t / (a_tᴴR⁻¹a_t) — (F, C)
    complex64, unit response toward the target.
    """
    at = jnp.asarray(steer_target)
    C = at.shape[-1]
    R = at[..., :, None] * jnp.conj(at[..., None, :])                # (F,C,C)
    if steer_interf is not None:
        ai = jnp.asarray(steer_interf)
        if ai.ndim == 2:                       # a single interferer as (F, C)
            ai = ai[None]
        R = R + jnp.sum(ai[..., :, None] * jnp.conj(ai[..., None, :]), axis=0)
    R = R + diag_load * jnp.eye(C, dtype=R.dtype)
    Ra = jnp.einsum("fij,fj->fi", _inv_hermitian(R), at)
    denom = jnp.einsum("fi,fi->f", jnp.conj(at), Ra)
    return Ra / jnp.maximum(jnp.real(denom), 1e-12)[:, None]


def directivity_diagram(
    w_filter: jnp.ndarray,
    freqs: jnp.ndarray,
    thetas: jnp.ndarray | None = None,
    n_thetas: int = 181,
    dist_inter_sensor: float = 0.15,
    sound_speed: float = SOUND_SPEED,
    floor_db: float = -80.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Beamformer response surface |wᴴa(θ,f)|² in dB.

    Returns ``(thetas, diagram)`` with diagram (n_thetas, F) — the data the
    reference's ``directivity_filter_diagram_ULA`` (:71) renders with
    matplotlib. One einsum over the whole angle×frequency grid.
    """
    w = jnp.asarray(w_filter)                                        # (F, C)
    if thetas is None:
        thetas = jnp.linspace(-np.pi / 2, np.pi / 2, n_thetas)
    a = ula_steering(thetas, freqs, w.shape[-1], dist_inter_sensor, sound_speed)
    resp = jnp.einsum("fc,tfc->tf", jnp.conj(w), a)
    p = jnp.real(resp) ** 2 + jnp.imag(resp) ** 2
    return thetas, jnp.maximum(10.0 * jnp.log10(jnp.maximum(p, 0.0) + 1e-30),
                               floor_db)


def apply_beamformer(w_filter: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Apply w (F, C) to a multichannel STFT X (F, N, C) → (F, N)."""
    return jnp.einsum("fc,fnc->fn", jnp.conj(jnp.asarray(w_filter)),
                      jnp.asarray(X))

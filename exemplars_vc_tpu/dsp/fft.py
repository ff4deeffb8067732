"""FFT entry points for ``dsp/`` and ``world/``: XLA's native FFT along the
last axis (cuFFT on the GPU, DUCC on the CPU), exact to float32 rounding.

``n`` pads or truncates the last axis first, as in ``numpy.fft``.
"""

from __future__ import annotations

import jax.numpy as jnp


def rfft(x: jnp.ndarray, n: int | None = None) -> jnp.ndarray:
    """Real FFT along the last axis."""
    return jnp.fft.rfft(x, n=n, axis=-1)


def irfft(X: jnp.ndarray, n: int | None = None) -> jnp.ndarray:
    """Inverse real FFT along the last axis (default n = 2·(bins − 1))."""
    return jnp.fft.irfft(X, n=n, axis=-1)


def fft(x: jnp.ndarray, n: int | None = None) -> jnp.ndarray:
    """Full complex FFT along the last axis."""
    return jnp.fft.fft(x, n=n, axis=-1)


def ifft(X: jnp.ndarray, n: int | None = None) -> jnp.ndarray:
    """Full complex inverse FFT along the last axis."""
    return jnp.fft.ifft(X, n=n, axis=-1)


def rfft_magsq(x: jnp.ndarray, n: int | None = None) -> jnp.ndarray:
    """|rfft(x)|² along the last axis, as a real array."""
    s = jnp.fft.rfft(x, n=n, axis=-1)
    return jnp.real(s) ** 2 + jnp.imag(s) ** 2

"""Minimum-Q transform (MinQT): CQT low band + linear-FFT high band, with a
guaranteed per-bin minimum Q and an EXACT iterative inverse.

Covers pyfasst's ``MinQTKernel``/``MinQTransfo``
(``dependencies/pyfasst-master/pyfasst/tftransforms/minqt.py:309-402`` — the
one transform that had no dedicated counterpart). The
defining construction (minqt.py:318-325): with ``b`` bins per octave,

    Q    = q / (2^(1/b) − 1)            # the minimum Q of the transform
    Kmax = ceil(Q)
    fmax = 2^(−1/b) · Kmax · fs / N_lin # CQ/linear split frequency

Below ``fmax``: log-spaced constant-Q bins (Q exactly the minimum). At and
above ``fmax``: bins ``p = Kmax … N_lin/2`` of an ``N_lin``-point windowed
FFT, whose effective Q is ``p ≥ Kmax ≥ Q`` — so EVERY bin of the transform
satisfies Q ≥ Q_min, hence "minimum-Q". Atoms use the sqrt-Blackman-Harris
window, as pyfasst does (its ``sqrt_blackmanharris`` default).

Accelerator-first design — nothing resembles pyfasst's per-octave FFT recursion with
per-octave decimation and atom hops:

- all atoms live on ONE common hop grid (pyfasst's "rasterized" view), and
  analysis is a single strided ``lax.conv`` against a real cos/sin kernel
  bank (the fused frame+window+transform pattern shared with dsp/stft.py and
  dsp/cqt.py) — by the min-Q construction the SHORTEST atom has length
  ≈ N_lin·(Q/Kmax), so a hop of N_lin/4 gives every bin ≥4× overlap;
- the inverse is the frame-theoretic least squares x̂ = (AᴴA)⁻¹Aᴴc solved
  with conjugate gradients whose matvec is the same conv kernel (adjoint =
  transposed conv) — machine-precision reconstruction in a few tens of
  iterations, where pyfasst's icqt is only approximate.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def sqrt_blackmanharris(n: int) -> np.ndarray:
    """sqrt of the 4-term Blackman-Harris window (pyfasst's default atom
    window, ``tftransforms/minqt.py:21-28``)."""
    m = np.arange(n)
    w = (0.35875 - 0.48829 * np.cos(2 * np.pi * m / (n - 1))
         + 0.14128 * np.cos(4 * np.pi * m / (n - 1))
         - 0.01168 * np.cos(6 * np.pi * m / (n - 1)))
    return np.sqrt(np.maximum(w, 0.0))


class MinQTPlan(NamedTuple):
    kernel: np.ndarray      # (2·n_bins, L) float32 cos/sin analysis atoms
    n_bins: int
    n_cq: int               # leading CQ bins; the rest are linear bins
    hop: int
    L: int                  # common (centered) atom frame length
    freqs_hz: np.ndarray    # (n_bins,) ascending center frequencies
    q_values: np.ndarray    # (n_bins,) per-bin Q = f_k · len_k / fs
    q_min: float
    split_hz: float
    lin_fft: int


@lru_cache(maxsize=8)
def minqt_plan(
    sr: int,
    bins_per_octave: int = 12,
    fmin: float = 65.40639132514966,     # C2
    lin_fft: int = 1024,
    q: float = 1.0,
    hop: int | None = None,
) -> MinQTPlan:
    Q = q / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    kmax = int(np.ceil(Q))
    split = 2.0 ** (-1.0 / bins_per_octave) * kmax * sr / lin_fft
    if split <= fmin:
        raise ValueError(
            f"split {split:.1f} Hz <= fmin {fmin:.1f} Hz: raise lin_fft or fmin"
        )
    # CQ bins ascending, top bin one CQ step below the split
    n_cq = int(np.floor(bins_per_octave * np.log2(split / fmin))) + 1
    freqs_cq = split * 2.0 ** (-np.arange(n_cq, 0, -1) / bins_per_octave)
    lens_cq = np.round(Q * sr / freqs_cq).astype(int)
    # linear bins p = kmax … lin_fft/2 of the lin_fft-point windowed FFT
    p = np.arange(kmax, lin_fft // 2 + 1)
    freqs_lin = p * sr / lin_fft

    L = int(max(lens_cq.max(), lin_fft))
    n_bins = n_cq + len(p)
    kre = np.zeros((n_bins, L), np.float32)
    kim = np.zeros((n_bins, L), np.float32)
    for k, (fk, nk) in enumerate(zip(freqs_cq, lens_cq)):
        n = np.arange(nk)
        win = sqrt_blackmanharris(nk)
        phase = 2 * np.pi * fk / sr * n
        start = (L - nk) // 2
        kre[k, start : start + nk] = (win * np.cos(phase)) * (2.0 / nk)
        kim[k, start : start + nk] = (win * np.sin(phase)) * (2.0 / nk)
    win_lin = sqrt_blackmanharris(lin_fft)
    start = (L - lin_fft) // 2
    n = np.arange(lin_fft)
    for i, pk in enumerate(p):
        phase = 2 * np.pi * pk / lin_fft * n
        kre[n_cq + i, start : start + lin_fft] = (
            win_lin * np.cos(phase) * (2.0 / lin_fft)
        )
        kim[n_cq + i, start : start + lin_fft] = (
            win_lin * np.sin(phase) * (2.0 / lin_fft)
        )
    freqs = np.concatenate([freqs_cq, freqs_lin])
    q_values = freqs * np.concatenate(
        [lens_cq, np.full(len(p), lin_fft)]
    ) / sr
    return MinQTPlan(
        kernel=np.concatenate([kre, kim], axis=0),
        n_bins=n_bins, n_cq=n_cq, hop=int(hop or lin_fft // 4), L=L,
        freqs_hz=freqs, q_values=q_values, q_min=Q,
        split_hz=split, lin_fft=lin_fft,
    )


def _conv_analysis(x, kernel, hop):
    """x (N, T_padded) real → (N, 2K, frames) strided correlation."""
    xb = x[:, None, :]
    k = kernel[:, None, :]                                    # (2K, 1, L)
    return jax.lax.conv_general_dilated(
        xb, k, window_strides=(hop,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
    )


def _conv_adjoint(c, kernel, hop, t_padded):
    """Adjoint of _conv_analysis: (N, 2K, frames) → (N, T_padded)."""
    k = kernel[:, None, :]
    y = jax.lax.conv_general_dilated(
        c, jnp.flip(k, -1), window_strides=(1,), padding=[(k.shape[-1] - 1,) * 2],
        lhs_dilation=(hop,), dimension_numbers=("NCH", "IOH", "NCH"),
    )[:, 0, :]
    if y.shape[-1] < t_padded:   # last partial frame: adjoint support ends early
        y = jnp.pad(y, ((0, 0), (0, t_padded - y.shape[-1])))
    return y[:, : t_padded]


@partial(jax.jit, static_argnames=("sr", "bins_per_octave", "fmin", "lin_fft",
                                   "q", "hop"))
def minqt(
    x: jnp.ndarray,
    sr: int = 16000,
    bins_per_octave: int = 12,
    fmin: float = 65.40639132514966,
    lin_fft: int = 1024,
    q: float = 1.0,
    hop: int | None = None,
) -> jnp.ndarray:
    """MinQT analysis of ``x`` (..., T) → complex (..., frames, n_bins)."""
    p = minqt_plan(sr, bins_per_octave, float(fmin), lin_fft, float(q), hop)
    lead = x.shape[:-1]
    pad = [(0, 0)] * (x.ndim - 1) + [(p.L // 2, p.L // 2)]
    xp = jnp.pad(x.astype(jnp.float32), pad)                  # zero pad: linear op
    out = _conv_analysis(xp.reshape((-1, xp.shape[-1])), jnp.asarray(p.kernel),
                         p.hop)
    re = jnp.moveaxis(out[:, : p.n_bins, :], 1, 2)
    im = jnp.moveaxis(out[:, p.n_bins :, :], 1, 2)
    return jax.lax.complex(re, -im).reshape(lead + re.shape[1:])


@partial(jax.jit, static_argnames=("length", "sr", "bins_per_octave", "fmin",
                                   "lin_fft", "q", "hop", "n_cg"))
def iminqt(
    coeffs: jnp.ndarray,
    length: int,
    sr: int = 16000,
    bins_per_octave: int = 12,
    fmin: float = 65.40639132514966,
    lin_fft: int = 1024,
    q: float = 1.0,
    hop: int | None = None,
    n_cg: int = 48,
) -> jnp.ndarray:
    """Least-squares inverse: the x̂ of given ``length`` whose MinQT best
    matches ``coeffs`` (exact reconstruction for in-band signals).

    Solves (AᴴA) x = Aᴴ c by conjugate gradients; both operators are the
    analysis conv and its transpose — all matmul work, no matrix ever built."""
    p = minqt_plan(sr, bins_per_octave, float(fmin), lin_fft, float(q), hop)
    kernel = jnp.asarray(p.kernel)
    lead = coeffs.shape[:-2]
    c = coeffs.reshape((-1,) + coeffs.shape[-2:])
    # complex (N, F, K) → stacked real channels (N, 2K, F), undoing the −im
    cr = jnp.moveaxis(jnp.real(c), 1, 2)
    ci = jnp.moveaxis(-jnp.imag(c), 1, 2)
    c2 = jnp.concatenate([cr, ci], axis=1)
    t_padded = length + 2 * (p.L // 2)

    def A(x):
        return _conv_analysis(x, kernel, p.hop)

    def AH(cc):
        return _conv_adjoint(cc, kernel, p.hop, t_padded)

    b = AH(c2)

    def S(x):
        return AH(A(x))

    x0 = jnp.zeros_like(b)
    r0 = b - S(x0)

    def cg_step(state, _):
        x, r, d, rs = state
        Sd = S(d)
        alpha = rs / jnp.maximum(jnp.sum(d * Sd, -1, keepdims=True), 1e-30)
        x = x + alpha * d
        r = r - alpha * Sd
        rs_new = jnp.sum(r * r, -1, keepdims=True)
        d = r + (rs_new / jnp.maximum(rs, 1e-30)) * d
        return (x, r, d, rs_new), None

    rs0 = jnp.sum(r0 * r0, -1, keepdims=True)
    (x, _, _, _), _ = jax.lax.scan(cg_step, (x0, r0, r0, rs0), None,
                                   length=n_cg)
    x = x[:, p.L // 2 : p.L // 2 + length]
    return x.reshape(lead + (length,))

"""Non-stationary Gabor transform (NSGT), matrix form, with exact inverse.

Covers the NSGT capability of the reference's vendored pyfasst transforms
(``dependencies/pyfasst-master/pyfasst/tftransforms/nsgt/`` — nsgfwin window
construction, nsgtf/nsigtf forward/inverse, nsdual dual frames): a painless
constant-Q Gabor frame with frequency-adaptive windows and perfect
reconstruction through the canonical dual frame.

Accelerator-first design, not a translation: pyfasst runs one ragged per-band FFT per
window via numpy; here every step is a static-shape batched matmul. The whole
signal spectrum comes from the native FFT (``dsp/fft.py``), the
band analysis is one gather + one length-M batched inverse DFT over ALL bands
at once (matrix form: every band shares the same number of time samples M,
chosen as a divisor of the padded signal length so the modulation property
holds), and synthesis is the mirrored gather/scatter with precomputed dual
windows. All plan construction (windows, supports, duals) is host-side numpy
cached per parameter set; the jitted path is pure gathers and matmuls.

Frame construction (Velasco et al. 2011, "Constructing an invertible
constant-Q transform with nonstationary Gabor frames"): band centers at DC,
log-spaced f_k = fmin·2^(k/B) up to Nyquist, Nyquist, and mirrored negative
bands; each window is an asymmetric Hann reaching zero exactly at the
neighboring centers, so the frame operator diagonal d(f) = Σ_k g_k(f)² is
strictly positive and the canonical dual is g̃_k = g_k / d.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from exemplars_vc_tpu.dsp import fft as F


class NSGTPlan(NamedTuple):
    L: int            # padded signal/DFT length
    M: int            # time samples per band (divides L)
    n_bands: int      # total bands incl. DC, Nyquist, negative mirror
    n_pos: int        # positive-frequency log bands (excl. DC/Nyquist)
    idx: np.ndarray   # (n_bands, Lg) int32 DFT-bin index of each support tap
    win: np.ndarray   # (n_bands, Lg) float32 analysis window values (0 = pad)
    dual: np.ndarray  # (n_bands, Lg) float32 canonical dual window values
    pos: np.ndarray   # (n_bands, Lg) int32 position of each tap in the M-buffer
    perm: np.ndarray  # (n_bands, M) int32 roll permutation for the forward pack
    freqs: np.ndarray  # (n_bands,) band center frequencies in Hz


def nsgt_frequencies(sr: int, fmin: float, bins_per_octave: int = 12) -> np.ndarray:
    """Positive log-spaced band centers in Hz (excluding DC and Nyquist)."""
    n = int(np.floor(bins_per_octave * np.log2((sr / 2) / fmin)))
    f = fmin * 2.0 ** (np.arange(n + 1) / bins_per_octave)
    return f[f < sr / 2]


def _is_smooth(n: int) -> bool:
    for p in (2, 3, 5, 7):
        while n % p == 0:
            n //= p
    return n == 1


@lru_cache(maxsize=8)
def _plan(sr: int, Ls: int, fmin: float, bins_per_octave: int) -> NSGTPlan:
    # pad to 256×(7-smooth): keeps every prime factor of the length-L FFT
    # (and of every divisor M) small, so no FFT meets a large prime length
    m = -(-Ls // 256)
    while not _is_smooth(m):
        m += 1
    L = 256 * m
    fpos = nsgt_frequencies(sr, fmin, bins_per_octave)
    n_pos = len(fpos)
    if n_pos < 2:
        raise ValueError("nsgt: need at least 2 positive bands (raise sr/2/fmin)")
    # circular center list in DFT bins: DC, positives, Nyquist, mirrored negatives
    bpos = fpos * L / sr
    centers = np.concatenate([[0.0], bpos, [L / 2.0], L - bpos[::-1]])
    n_bands = len(centers)
    ext = np.concatenate([[centers[-1] - L], centers, [L + centers[0]]])
    lwid = centers - ext[:-2]    # distance to left neighbor (bins)
    rwid = ext[2:] - centers     # distance to right neighbor

    starts = np.floor(centers - lwid).astype(int) + 1
    stops = np.ceil(centers + rwid).astype(int) - 1   # inclusive
    lens = stops - starts + 1
    Lg = int(lens.max())

    idx = np.zeros((n_bands, Lg), np.int32)
    win = np.zeros((n_bands, Lg), np.float32)
    for k in range(n_bands):
        u = starts[k] + np.arange(lens[k])            # unwrapped bin positions
        rel = u - centers[k]
        g = np.where(
            rel <= 0,
            np.cos(0.5 * np.pi * np.clip(-rel / lwid[k], 0, 1)) ** 2,
            np.cos(0.5 * np.pi * np.clip(rel / rwid[k], 0, 1)) ** 2,
        )
        idx[k, : lens[k]] = np.mod(u, L)
        win[k, : lens[k]] = g

    # frame operator diagonal and canonical dual
    d = np.zeros(L, np.float64)
    np.add.at(d, idx.ravel(), (win.astype(np.float64) ** 2).ravel())
    if d.min() <= 1e-10:
        raise ValueError("nsgt: frame operator not invertible (coverage gap)")
    dual = (win / d[idx]).astype(np.float32)
    dual[win == 0] = 0.0

    # M: smallest divisor of L that fits the widest support (mod-M injective,
    # and M | L keeps the modulation property (u mod L) mod M == u mod M)
    M = next(m for m in sorted(
        {dv for i in range(1, int(np.sqrt(L)) + 1) if L % i == 0 for dv in (i, L // i)}
    ) if m >= Lg)

    p0 = np.mod(starts, M)
    j = np.arange(Lg)[None, :]
    pos = np.mod(p0[:, None] + j, M).astype(np.int32)
    q = np.arange(M)[None, :]
    perm = np.mod(q - p0[:, None], M).astype(np.int32)
    freqs = np.concatenate([[0.0], fpos, [sr / 2.0], -fpos[::-1] + 0.0])
    return NSGTPlan(L, int(M), n_bands, n_pos, idx, win, dual, pos, perm, freqs)


def nsgt(
    x: jnp.ndarray,
    sr: int = 16000,
    fmin: float = 65.40639132514966,   # C2
    bins_per_octave: int = 12,
) -> jnp.ndarray:
    """NSGT coefficients of ``x`` (..., T) → complex (..., n_bands, M).

    Matrix form: every band yields M coefficient frames (M chosen by the plan;
    ``nsgt_plan(sr, T, fmin, bins_per_octave).M``). Band order: DC, positive
    log bands, Nyquist, mirrored negative bands (``plan.freqs``).
    """
    if jnp.iscomplexobj(x):
        raise ValueError("nsgt expects a real signal (got complex input)")
    p = _plan(sr, x.shape[-1], float(fmin), bins_per_octave)
    X = F.fft(x.astype(jnp.float32), n=p.L)
    Xr, Xi = jnp.real(X), jnp.imag(X)
    w = jnp.asarray(p.win)
    vr = Xr[..., jnp.asarray(p.idx)] * w                 # (..., B, Lg)
    vi = Xi[..., jnp.asarray(p.idx)] * w
    padM = [(0, 0)] * (vr.ndim - 1) + [(0, p.M - vr.shape[-1])]
    vr, vi = jnp.pad(vr, padM), jnp.pad(vi, padM)
    perm = jnp.broadcast_to(jnp.asarray(p.perm), vr.shape)
    yr = jnp.take_along_axis(vr, perm, -1)
    yi = jnp.take_along_axis(vi, perm, -1)
    return F.ifft(jax.lax.complex(yr, yi))               # (..., B, M)


def insgt(
    c: jnp.ndarray,
    length: int,
    sr: int = 16000,
    fmin: float = 65.40639132514966,
    bins_per_octave: int = 12,
) -> jnp.ndarray:
    """Inverse NSGT: coefficients (..., n_bands, M) → real signal (..., length)."""
    p = _plan(sr, int(length), float(fmin), bins_per_octave)
    if c.shape[-2:] != (p.n_bands, p.M):
        raise ValueError(
            f"insgt: coefficients {c.shape[-2:]} do not match the plan for "
            f"(sr={sr}, length={length}, fmin={fmin}, B={bins_per_octave}) — "
            f"expected {(p.n_bands, p.M)}")
    Y = F.fft(c)                                         # (..., B, M)
    posm = jnp.broadcast_to(jnp.asarray(p.pos), Y.shape[:-1] + (p.pos.shape[-1],))
    vr = jnp.take_along_axis(jnp.real(Y), posm, -1) * jnp.asarray(p.dual)
    vi = jnp.take_along_axis(jnp.imag(Y), posm, -1) * jnp.asarray(p.dual)
    lead = c.shape[:-2]
    flat_idx = jnp.asarray(p.idx).reshape(-1)
    Xr = jnp.zeros(lead + (p.L,), jnp.float32).at[..., flat_idx].add(
        vr.reshape(lead + (-1,)))
    Xi = jnp.zeros(lead + (p.L,), jnp.float32).at[..., flat_idx].add(
        vi.reshape(lead + (-1,)))
    x = jnp.real(F.ifft(jax.lax.complex(Xr, Xi)))
    return x[..., :length]


def nsgt_plan(sr: int, length: int, fmin: float = 65.40639132514966,
              bins_per_octave: int = 12) -> NSGTPlan:
    """Expose the cached plan (band count, M, center frequencies)."""
    return _plan(sr, int(length), float(fmin), bins_per_octave)

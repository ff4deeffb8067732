"""Shared Flanagan instantaneous-frequency refinement core.

The single estimator behind WORLD's StoneMask refinement (stonemask.cpp,
``pw.stonemask`` at reference ``04_align_n_nmf.py:405-408``) and Harvest's
GetRefinedF0 (harvest.cpp step 4): per candidate frequency, a 3-period
Blackman window and its discrete derivative window; Flanagan's estimator
gives the instantaneous frequency per bin, and the refined f0 is the
amplitude-weighted mean of inst_freq(k·f0)/k over the first ``n_harmonics``
harmonics. Harvest additionally scores each candidate by the inverse mean
relative harmonic deviation; computing it here costs a few fused
elementwise ops, so both callers share one body (they previously carried
duplicated copies — dedup'd round 3, goldens unchanged).

Batched formulation: every (frame × candidate) window goes through one
static-shape rFFT pair sized by the LARGEST window (``max_win`` from
f0_floor), masked per row — the same estimator on a finer bin grid for
high-f0 rows (WORLD picks a per-frame FFT size instead).
"""

from __future__ import annotations

import jax.numpy as jnp

from exemplars_vc_tpu.dsp import fft as _fft


def flanagan_refine(
    x: jnp.ndarray,
    cfs: jnp.ndarray,
    centers: jnp.ndarray,
    sr: int,
    fft_size: int,
    max_win: int,
    n_harmonics: int = 6,
):
    """Refine candidate frequencies ``cfs`` (N,) at sample ``centers`` (N,).

    ``cfs`` must already be clipped to a positive range (callers substitute
    f0_floor for unvoiced rows and gate afterwards). Returns
    (refined (N,), score (N,), den (N,)) where ``score`` is Harvest's
    reliability (inverse mean relative harmonic deviation) and ``den`` is
    the total harmonic amplitude (0 ⇒ no usable harmonics).
    """
    half = jnp.ceil(3.0 * sr / cfs / 2.0)                       # (N,)
    base = jnp.arange(max_win) - max_win // 2                   # (L,)
    inside = jnp.abs(base)[None, :] <= half[:, None]
    idx = jnp.clip(centers[:, None] + base[None, :], 0, x.shape[0] - 1)
    seg = x[idx]
    n_win = 2.0 * half[:, None] + 1.0
    phase = 2.0 * jnp.pi * base[None, :] / n_win
    main = (0.42 + 0.5 * jnp.cos(phase) + 0.08 * jnp.cos(2.0 * phase)) * inside
    # discrete derivative window with WORLD's edge handling (main = 0 outside)
    diffw = -(jnp.pad(main, ((0, 0), (0, 1)))[:, 1:]
              - jnp.pad(main, ((0, 0), (1, 0)))[:, :-1]) / 2.0

    X = _fft.rfft(seg * main, n=fft_size)
    Xd = _fft.rfft(seg * diffw, n=fft_size)
    power = X.real * X.real + X.imag * X.imag
    B = power.shape[-1]
    freqs = jnp.arange(B) * (sr / fft_size)
    inst = freqs[None, :] + (X.real * Xd.imag - X.imag * Xd.real) / jnp.maximum(
        power, 1e-30
    ) * (sr / (2.0 * jnp.pi))

    num = jnp.zeros_like(cfs)
    den = jnp.zeros_like(cfs)
    dev = jnp.zeros_like(cfs)
    for k in range(1, n_harmonics + 1):
        j = jnp.floor(cfs * k * fft_size / sr + 0.5).astype(jnp.int32)
        ok = (k * cfs < sr / 2.0) & (j < B)
        j = jnp.clip(j, 0, B - 1)
        amp = jnp.sqrt(jnp.take_along_axis(power, j[:, None], -1)[:, 0])
        fk = jnp.take_along_axis(inst, j[:, None], -1)[:, 0]
        amp = jnp.where(ok, amp, 0.0)
        num = num + fk / k * amp
        den = den + amp
        dev = dev + amp * jnp.abs(fk / k - cfs) / cfs
    refined = num / jnp.maximum(den, 1e-30)
    score = 1.0 / (dev / jnp.maximum(den, 1e-30) + 1e-12)
    return refined, score, den

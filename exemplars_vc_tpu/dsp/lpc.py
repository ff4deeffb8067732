"""LPC (Levinson-Durbin) and LSP conversion in JAX.

Replaces ``pysptk.lpc`` / ``pysptk.lpc2lsp`` used by the AMF frequency-warping
variant (reference ``02_freq_warping_AMF.py:67-81``: hamming-windowed frames →
per-frame LPC → line spectral pairs). Accelerator-first: autocorrelation via batched
rFFT, Levinson recursion as a ``lax.scan`` over the (small, static) order,
vmapped over all frames; LSP roots found by sign-change scan + fixed-iteration
bisection on the Chebyshev-transformed symmetric/antisymmetric polynomials.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from exemplars_vc_tpu.dsp import fft as _fft


@partial(jax.jit, static_argnames=("order",))
def lpc(frames: jnp.ndarray, order: int = 20) -> jnp.ndarray:
    """Windowed frames (..., N) → LPC coefficients (..., order+1).

    Output layout matches SPTK's lpc: ``[sqrt(residual_gain), a_1 … a_p]``
    for the all-pole model H(z) = g / (1 + Σ a_k z^{-k})."""
    n = frames.shape[-1]
    n_fft = 1
    while n_fft < 2 * n:
        n_fft *= 2
    spec = _fft.rfft_magsq(frames, n=n_fft)
    r = _fft.irfft(spec, n=n_fft)[..., : order + 1]
    r0 = jnp.maximum(r[..., :1], 1e-12)
    r = r / r0  # normalized autocorrelation; gain restored at the end

    batch = r.shape[:-1]
    idx = jnp.arange(order + 1)
    a = jnp.zeros(batch + (order + 1,), dtype=frames.dtype).at[..., 0].set(1.0)
    err = jnp.ones(batch, dtype=frames.dtype)

    def step(carry, m):
        a, err = carry
        rev_idx = jnp.clip(m - idx, 0, order)
        mask = (idx >= 1) & (idx <= m - 1)
        r_rev = r[..., rev_idx]                      # r[m-i] at position i
        acc = jnp.sum(jnp.where(mask, a * r_rev, 0.0), axis=-1)
        k = -(jnp.take(r, m, axis=-1) + acc) / jnp.maximum(err, 1e-12)
        a_rev = a[..., rev_idx]                      # a[m-i] at position i
        upd = jnp.where(mask, a + k[..., None] * a_rev, a)
        a = jnp.where(idx == m, k[..., None], upd)
        err = err * (1.0 - k * k)
        return (a, err), None

    (a, err), _ = jax.lax.scan(step, (a, err), jnp.arange(1, order + 1))
    gain = jnp.sqrt(jnp.maximum(err * r0[..., 0], 1e-20))
    return a.at[..., 0].set(gain)


def _cheb_eval(coeffs: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Σ_k coeffs[k]·T_k(x) at points x, via T_k(cos θ) = cos kθ."""
    theta = jnp.arccos(jnp.clip(x, -1.0, 1.0))
    basis = jnp.cos(theta[..., None] * jnp.arange(coeffs.shape[0]))
    return basis @ coeffs


def _lsp_single(a1: jnp.ndarray, order: int, n_grid: int, n_bisect: int) -> jnp.ndarray:
    """LSP frequencies for one monic LPC vector a1 (order+1,), a1[0] == 1."""
    # P(z) = A(z) + z^{-(p+1)}·A(z⁻¹) has DEGREE p+1 (length p+2): append a
    # zero to A and prepend one to the reversal. (Building these one degree
    # short — a1 ± a1[::-1] — destroys the guaranteed roots at z = ∓1 and
    # every LSP after the silent mis-deflation; caught by the value test
    # against polynomial root-finding in tests/test_dsp.py.)
    zero = jnp.zeros((1,), a1.dtype)
    ext = jnp.concatenate([a1, zero])
    flip = jnp.concatenate([zero, a1[::-1]])
    p = ext + flip
    q = ext - flip

    def deflate(c, root_sign):
        # synthetic division of Σ c_k z^{-k} by (1 − root_sign·z⁻¹)
        def step(carry, ck):
            out = ck + root_sign * carry
            return out, out

        _, res = jax.lax.scan(step, jnp.zeros((), dtype=c.dtype), c)
        return res[:-1]

    p_d = deflate(p, -1.0)  # P has a root at z = −1
    q_d = deflate(q, 1.0)   # Q has a root at z = +1

    def to_cheb(c):
        # palindromic even-degree poly → Chebyshev coeffs of z^m·poly in x=cosω
        m = (c.shape[0] - 1) // 2
        return jnp.concatenate([c[m : m + 1], 2.0 * c[:m][::-1]])

    m = order // 2
    x = jnp.cos(jnp.linspace(1e-4, jnp.pi - 1e-4, n_grid))  # ω ascending

    def roots_of(cheb):
        vals = _cheb_eval(cheb, x)
        flips = jnp.signbit(vals[1:]) != jnp.signbit(vals[:-1])
        pos = jnp.argsort(~flips, stable=True)[:m]
        pos = jnp.sort(pos)
        lo, hi = x[pos], x[pos + 1]

        def bis(carry, _):
            lo, hi = carry
            mid = 0.5 * (lo + hi)
            same = jnp.signbit(_cheb_eval(cheb, mid)) == jnp.signbit(_cheb_eval(cheb, lo))
            return (jnp.where(same, mid, lo), jnp.where(same, hi, mid)), None

        (lo, hi), _ = jax.lax.scan(bis, (lo, hi), None, length=n_bisect)
        return jnp.arccos(jnp.clip(0.5 * (lo + hi), -1.0, 1.0))

    lsp = jnp.concatenate([roots_of(to_cheb(p_d)), roots_of(to_cheb(q_d))])
    return jnp.sort(lsp)


@partial(jax.jit, static_argnames=("n_grid", "n_bisect"))
def lpc_to_lsp(a: jnp.ndarray, n_grid: int = 1024, n_bisect: int = 30) -> jnp.ndarray:
    """LPC (..., order+1) → LSP frequencies (..., order) in (0, π), ascending.

    The gain term a[..., 0] is ignored (treated as monic), matching
    ``pysptk.lpc2lsp`` input conventions."""
    order = a.shape[-1] - 1
    if order % 2 != 0:
        raise NotImplementedError("lpc_to_lsp currently supports even LPC order")
    a1 = a.at[..., 0].set(1.0)
    flat = a1.reshape((-1, order + 1))
    out = jax.vmap(lambda v: _lsp_single(v, order, n_grid, n_bisect))(flat)
    return out.reshape(a.shape[:-1] + (order,))

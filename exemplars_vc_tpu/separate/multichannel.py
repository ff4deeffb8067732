"""Multichannel NMF source separation — the FASST model family, batched.

Re-designs the core of the reference's vendored pyfasst
(``dependencies/pyfasst-master/pyfasst/audioModel.py``: ``class FASST`` :66,
``MultiChanNMFInst_FASST`` :2296, ``MultiChanNMFConv`` :2422): the local
Gaussian model where each source j has

- a spectral power model  v_j(f, n) = Σ_k W_j[f, k] · H_j[k, n]   (NMF), and
- a spatial model          R_j(f)   (C×C Hermitian PSD covariance),

and the mixture STFT x(f, n) ∈ ℂ^C is modeled as a zero-mean Gaussian with
covariance Σ_x(f, n) = Σ_j v_j(f, n) R_j(f). A full-rank R_j is the
convolutive model (``MultiChanNMFConv``); rank-1 instantaneous mixing
(``MultiChanNMFInst_FASST``) is the special case R_j = a_j a_jᴴ, which the
full-rank parameterization subsumes (and is the recommended model for real
reverberant mixtures). Estimation is the standard EM for this model
(Ozerov & Févotte 2010, the FASST paper's ancestor; pyfasst's GEM iteration
``audioModel.py:GEM_iteration`` family):

E-step (per TF bin, all bins batched):
    G_j = v_j R_j Σ_x⁻¹                       (Wiener gain, C×C)
    ŷ_j = G_j x                               (posterior source image mean)
    R̂_j = ŷ_j ŷ_jᴴ + (I − G_j) v_j R_j        (posterior second moment)
M-step:
    R_j(f)   = (1/N) Σ_n R̂_j(f, n) / v_j(f, n)
    z_j(f,n) = (1/C) Re tr(R_j(f)⁻¹ R̂_j(f, n))
    one IS-NMF multiplicative update of (W_j, H_j) toward z_j.

Design choices: every EM step is a fixed-shape batch of einsums/matmuls
over all (f, n) bins at once inside one ``lax.fori_loop`` (pyfasst loops in
numpy on host); C×C inverses are closed-form for C=2 (the FASST use case) so
no per-bin linalg kernel is needed; complex arrays stay on the device
(separated audio is returned real via the ISTFT).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_EPS = 1e-10


class MultichannelNMF(NamedTuple):
    """Fitted model: W (J,F,K), H (J,K,N) real; R (J,F,C,C) complex."""

    W: jnp.ndarray
    H: jnp.ndarray
    R: jnp.ndarray
    neg_log_like: jnp.ndarray   # per-EM-iteration data negative log-likelihood


def _inv_hermitian(M: jnp.ndarray) -> jnp.ndarray:
    """Inverse of batched Hermitian PSD matrices (..., C, C).

    C=2 is closed-form (one reciprocal determinant — no linalg kernel, maps
    to pure elementwise ops); larger C falls back to jnp.linalg.inv.
    """
    C = M.shape[-1]
    if C == 1:
        return 1.0 / M
    if C == 2:
        a = M[..., 0, 0]
        b = M[..., 0, 1]
        c = M[..., 1, 0]
        d = M[..., 1, 1]
        det = a * d - b * c
        inv_det = 1.0 / det
        row0 = jnp.stack([d, -b], axis=-1)
        row1 = jnp.stack([-c, a], axis=-1)
        return jnp.stack([row0, row1], axis=-2) * inv_det[..., None, None]
    return jnp.linalg.inv(M)


def _hermitize(M: jnp.ndarray) -> jnp.ndarray:
    return 0.5 * (M + jnp.conj(jnp.swapaxes(M, -1, -2)))


def _spatial_estep(XX, v, R):
    """Shared E-step + spatial M-step of the FASST local Gaussian model.

    XX: (F, N, C, C) data outer products; v: (J, F, N) current spectral
    power model; R: (J, F, C, C) spatial covariances. Returns
    (R_new, scale, z, nll): the trace-normalized updated spatial
    covariances, the (J, F) scale to ship into the spectral model,
    the (J, F, N) posterior spectral statistics, and the data negative
    log-likelihood under the CURRENT parameters.
    """
    C = XX.shape[-1]
    rdt = XX.real.dtype
    eye = jnp.eye(C, dtype=XX.dtype)

    # Σ_x(f,n) = Σ_j v_j R_j(f) + δI — δ scaled to the mixture power
    Sigma = jnp.einsum("jfn,jfcd->fncd", v.astype(rdt), R)
    tr = jnp.real(jnp.trace(Sigma, axis1=-2, axis2=-1))
    delta = (1e-6 * tr / C + 1e-12).astype(rdt)
    Sigma = Sigma + delta[..., None, None] * eye
    Sinv = _inv_hermitian(Sigma)                               # (F,N,C,C)

    # Wiener gains and posterior moments, all sources at once
    vR = v[..., None, None].astype(rdt) * R[:, :, None, :, :]  # (J,F,N,C,C)
    G = jnp.einsum("jfncd,fnde->jfnce", vR, Sinv)              # (J,F,N,C,C)
    # ŷŷᴴ = G (x xᴴ) Gᴴ ; R̂ = ŷŷᴴ + (I − G) v R
    GX = jnp.einsum("jfncd,fnde->jfnce", G, XX)
    yyH = jnp.einsum("jfncd,jfned->jfnce", GX, jnp.conj(G))
    Rhat = yyH + vR - jnp.einsum("jfncd,jfnde->jfnce", G, vR)

    # negative log-likelihood of the data under Σ_x (monotone under EM):
    # Σ_fn [ log det Σ_x + xᴴ Σ_x⁻¹ x ]
    if C == 2:
        det = jnp.real(
            Sigma[..., 0, 0] * Sigma[..., 1, 1]
            - Sigma[..., 0, 1] * Sigma[..., 1, 0]
        )
    else:
        det = jnp.real(jnp.linalg.det(Sigma))
    quad = jnp.real(jnp.einsum("fncd,fndc->fn", Sinv, XX))
    nll = jnp.sum(jnp.log(jnp.maximum(det, 1e-30)) + quad)

    # ---- M-step: spatial covariances ---------------------------------------
    R_new = _hermitize(jnp.mean(Rhat / v[..., None, None].astype(rdt), axis=2))
    # scale indeterminacy: normalize tr(R_j(f)) = C, energy into the spectra
    trR = jnp.maximum(jnp.real(jnp.trace(R_new, axis1=-2, axis2=-1)), _EPS)
    R_new = R_new * (C / trR)[..., None, None].astype(rdt)

    # ---- posterior spectral statistics --------------------------------------
    # ridge before inverting: a converged point source drives R_j(f) to the
    # rank-1 steering covariance, whose 2×2 determinant underflows float32
    # and turns the EM NaN (measured on an accelerator at ~6 iterations; CPU
    # survives marginally). R_new is trace-normalized to C, so a 1e-5·I load bounds
    # the condition number at ~2·10⁵ with negligible bias.
    Rinv = _inv_hermitian(R_new + 1e-5 * eye)
    z = jnp.real(jnp.einsum("jfcd,jfndc->jfn", Rinv, Rhat)) / C
    return R_new, trR / C, jnp.maximum(z, _EPS), nll


@partial(jax.jit, static_argnames=("n_em", "n_nmf_inner"))
def _em_loop(X, W0, H0, R0, n_em: int, n_nmf_inner: int):
    """X: (F, N, C) complex64. Returns the fitted MultichannelNMF."""
    # x xᴴ outer products are loop-invariant: (F, N, C, C)
    XX = X[..., :, None] * jnp.conj(X)[..., None, :]

    def em_step(carry, _):
        W, H, R = carry
        v = jnp.maximum(jnp.einsum("jfk,jkn->jfn", W, H), _EPS)   # (J,F,N)
        R_new, scale, z, nll = _spatial_estep(XX, v, R)
        W = W * scale[..., None]

        def nmf_update(_, WH):
            Wj, Hj = WH
            hat = jnp.maximum(jnp.einsum("jfk,jkn->jfn", Wj, Hj), _EPS)
            num = jnp.einsum("jfn,jkn->jfk", z / (hat * hat), Hj)
            den = jnp.einsum("jfn,jkn->jfk", 1.0 / hat, Hj)
            Wj = Wj * (num / jnp.maximum(den, _EPS))
            sumW = jnp.maximum(Wj.sum(axis=1, keepdims=True), _EPS)  # (J,1,K)
            Wj = Wj / sumW
            Hj = Hj * jnp.swapaxes(sumW, 1, 2)
            hat = jnp.maximum(jnp.einsum("jfk,jkn->jfn", Wj, Hj), _EPS)
            num = jnp.einsum("jfk,jfn->jkn", Wj, z / (hat * hat))
            den = jnp.einsum("jfk,jfn->jkn", Wj, 1.0 / hat)
            Hj = Hj * (num / jnp.maximum(den, _EPS))
            return Wj, Hj

        W, H = jax.lax.fori_loop(0, n_nmf_inner, nmf_update, (W, H))
        return (W, H, R_new), nll

    (W, H, R), nlls = jax.lax.scan(em_step, (W0, H0, R0), None, length=n_em)
    return MultichannelNMF(W, H, R, nlls)


@jax.jit
def _wiener_images_v(X, v, R):
    """Posterior source-image STFTs ŷ_j = v_j R_j Σ_x⁻¹ x — (J, F, N, C),
    for an arbitrary stacked spectral power model v (J, F, N)."""
    C = X.shape[-1]
    eye = jnp.eye(C, dtype=X.dtype)
    v = jnp.maximum(v, _EPS)
    Sigma = jnp.einsum("jfn,jfcd->fncd", v.astype(X.real.dtype), R)
    tr = jnp.real(jnp.trace(Sigma, axis1=-2, axis2=-1))
    delta = (1e-6 * tr / C + 1e-12).astype(X.real.dtype)
    Sinv = _inv_hermitian(Sigma + delta[..., None, None] * eye)
    vR = v[..., None, None].astype(X.real.dtype) * R[:, :, None, :, :]
    G = jnp.einsum("jfncd,fnde->jfnce", vR, Sinv)
    return jnp.einsum("jfncd,fnd->jfnc", G, X)


@jax.jit
def _wiener_images(X, W, H, R):
    """NMF-spectral-model wrapper around ``_wiener_images_v``."""
    v = jnp.einsum("jfk,jkn->jfn", W, H)
    return _wiener_images_v(X, v, R)


@partial(jax.jit, static_argnames=("n_sources", "F", "C", "mix"))
def random_spatial_init(key, n_sources: int, F: int, C: int,
                        mix: float = 0.2) -> jnp.ndarray:
    """Identity-plus-random-rank-1 spatial covariances (J, F, C, C).

    pyfasst inits its mixing parameters randomly too (``audioModel.py``
    ``_initialize_structures``); the complex perturbation uses independent
    real/imaginary draws so sources start with distinct inter-channel PHASE
    as well as gain. Jitted, like the rest of the complex glue
    (separate/glue.py)."""
    kr, ki = jax.random.split(key)
    a = (jax.random.normal(kr, (n_sources, C))
         + 1j * jax.random.normal(ki, (n_sources, C)))
    aaH = a[:, :, None] * jnp.conj(a)[:, None, :]
    aaH = aaH / jnp.maximum(
        jnp.real(jnp.trace(aaH, axis1=-2, axis2=-1))[:, None, None], _EPS)
    R = (jnp.eye(C, dtype=jnp.complex64)[None] * (1.0 - mix)
         + mix * C * aaH.astype(jnp.complex64))
    return jnp.broadcast_to(
        R[:, None], (n_sources, F, C, C)).astype(jnp.complex64)


def fit_multichannel_nmf(
    X: jnp.ndarray,
    n_sources: int = 2,
    n_components: int = 4,
    n_em: int = 50,
    n_nmf_inner: int = 1,
    key: jax.Array | None = None,
    W_init: jnp.ndarray | None = None,
    H_init: jnp.ndarray | None = None,
    R_init: jnp.ndarray | None = None,
) -> MultichannelNMF:
    """Fit the multichannel NMF local Gaussian model to a mixture STFT.

    X: (F, N, C) complex mixture STFT (freq-major). Inits follow pyfasst's
    convention (squared normal for W/H — ``audioModel.py`` inits its spectral
    factors the same way as ``tools/nmf.py``); R inits to identity plus a
    small source-specific Hermitian perturbation so sources are not spatially
    degenerate at step 0 (pyfasst inits its mixing parameters randomly too).
    """
    F, N, C = X.shape
    if key is None:
        key = jax.random.PRNGKey(0)
    kw, kh, kr = jax.random.split(key, 3)
    J, K = n_sources, n_components
    W = (jax.random.normal(kw, (J, F, K)) ** 2
         if W_init is None else jnp.asarray(W_init, jnp.float32))
    H = (jax.random.normal(kh, (J, K, N)) ** 2
         if H_init is None else jnp.asarray(H_init, jnp.float32))
    if R_init is None:
        R = random_spatial_init(kr, J, F, C)
    else:
        R = jnp.asarray(R_init, jnp.complex64)
    return _em_loop(jnp.asarray(X, jnp.complex64), W.astype(jnp.float32),
                    H.astype(jnp.float32), R, n_em, n_nmf_inner)


def separate_signal(
    x: jnp.ndarray,
    n_sources: int = 2,
    n_components: int = 4,
    n_em: int = 50,
    n_fft: int = 400,
    hop_length: int = 80,
    key: jax.Array | None = None,
    spectral_model: str = "nmf",
    spatial_init: str = "random",
) -> tuple[jnp.ndarray, MultichannelNMF]:
    """Separate a multichannel signal x (C, T) into source images (J, C, T).

    The end-to-end path of pyfasst's ``FASST.estim_param_a_post_model`` +
    ``separate_spatial_filter_comp`` (``audioModel.py``): STFT → EM fit →
    Wiener source images → ISTFT. Σ_j ŷ_j reconstructs the mixture in every
    TF bin the fitted model covers; the residual is the part of x lying in
    spatial directions the model assigns (near-)zero power — small after a
    converged fit, but not identically zero (Wiener masks sum to
    I − δΣ_x⁻¹, and Σ_x is the *model* covariance, not the empirical one).

    spectral_model: ``"nmf"`` (MultiChanNMF*), ``"hmm"`` / ``"shmm"``
    (MultiChanHMM — ``n_components`` is then the number of HMM states).
    spatial_init: ``"random"`` or ``"demix"`` (DEMIX direction clustering
    seeds the spatial covariances; stereo input only).
    """
    from exemplars_vc_tpu.separate.glue import host_stft_stack, images_istft

    x = jnp.asarray(x, jnp.float32)
    C, T = x.shape
    # complex glue runs jitted (separate/glue.py);
    # platform-exact host-f64 STFT input (glue.host_stft_stack)
    X = host_stft_stack(np.asarray(x), n_fft, hop_length, fnc=True)  # (F, N, C)

    R_init = None
    if spatial_init == "demix":
        from exemplars_vc_tpu.separate.demix import demix

        est = demix(x, n_sources=n_sources, n_fft=n_fft, hop_length=hop_length)
        R_init = est.spatial_init(np.arange(X.shape[0]) / n_fft)
    elif spatial_init != "random":
        raise ValueError(f"unknown spatial_init {spatial_init!r}")

    if spectral_model in ("hmm", "shmm"):
        from exemplars_vc_tpu.separate.hmm import fit_multichannel_hmm

        model = fit_multichannel_hmm(
            X, n_sources=n_sources, n_states=n_components, n_em=n_em,
            sticky=spectral_model == "shmm", key=key, R_init=R_init,
        )
    elif spectral_model == "nmf":
        model = fit_multichannel_nmf(
            X, n_sources=n_sources, n_components=n_components, n_em=n_em,
            key=key, R_init=R_init,
        )
    else:
        raise ValueError(f"unknown spectral_model {spectral_model!r}")
    Y = _wiener_images(X, model.W, model.H, model.R)    # (J, F, N, C)
    return images_istft(Y, n_fft, hop_length, T), model

"""Multichannel source-F0-filter separation — pyfasst's composed model, batched.

Covers the two FASST subclasses the reference vendors that COMBINE the SIMM
spectral model with the multichannel spatial EM
(``dependencies/pyfasst-master/pyfasst/audioModel.py``):

- ``multiChanSourceF0Filter`` (``audioModel.py:2551``): a FASST local
  Gaussian model where the lead source's spectral power is the Durrieu
  source/filter product — fixed harmonic-comb dictionary WF0 with free
  per-frame activations HF0, times a smooth filter WGAMMA·FW·TW (fixed Hann
  atom bank, free filter-shape weights FW, free filter activations TW) —
  and the remaining sources are free NMF "residual" components; every
  source carries its own spatial covariance estimated by the shared EM.
- ``multichanLead`` (``audioModel.py:3016``, ``runDecomp`` :3060): the
  estimation schedule that (1) separates lead/accompaniment with the
  STEREO SIMM first, (2) estimates spatial parameters from the separated
  signals (``demixOnSepSIMM`` :3325), (3) plugs the SIMM spectral
  parameters + spatial estimates into the composed model, and
  (4) re-estimates with the full EM before Wiener separation.

Accelerator-first: the spatial E/M step is the shared batched
``multichannel._spatial_estep`` (all TF bins per step, closed-form 2×2
Hermitian inverses); the lead source's spectral M-step is a fused-matmul
IS multiplicative update of (HF0, FW, TW) toward its posterior spectral
statistics z₀ — the same update forms as ``isnmf._sf_nmf_loop`` with z₀ as
the data; the accompaniment sources keep the plain NMF M-step. One
``lax.scan`` over EM iterations, nothing leaves the device.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from exemplars_vc_tpu.separate.multichannel import (
    _spatial_estep,
    _wiener_images_v,
    random_spatial_init,
)

_EPS = 1e-10


class MultichannelSF(NamedTuple):
    """Fitted composed model.

    Lead source (source 0): HF0 (NF0, N), FW (P, K), TW (K, N) with the
    fixed bases WF0 (F, NF0) and WGAMMA (F, P). Accompaniment sources
    1..J-1: W (J-1, F, Ka), H (J-1, Ka, N). R: (J, F, C, C) spatial
    covariances. neg_log_like: per-EM-iteration data NLL.
    """

    HF0: jnp.ndarray
    FW: jnp.ndarray
    TW: jnp.ndarray
    W: jnp.ndarray
    H: jnp.ndarray
    R: jnp.ndarray
    neg_log_like: jnp.ndarray


def _lead_power(WF0, WGAMMA, HF0, FW, TW):
    dot = partial(jnp.dot, preferred_element_type=jnp.float32)
    return dot(WF0, HF0) * dot(dot(WGAMMA, FW), TW)


def _sf_updates(z, WF0, WGAMMA, HF0, FW, TW):
    """One IS multiplicative update sweep of the lead factors toward z.

    Same update forms as ``isnmf._sf_nmf_loop`` (≙ pyfasst
    ``update_spectral_components`` for a two-factor spec comp,
    ``audioModel.py:1469``) with the posterior statistics z as the data:
    HF0, then FW (column-normalized, scale shipped into TW), then TW
    (per-frame-normalized, scale shipped into HF0).
    """
    dot = partial(jnp.dot, preferred_element_type=jnp.float32)

    # HF0
    SPHI = dot(dot(WGAMMA, FW), TW)
    v = jnp.maximum(dot(WF0, HF0) * SPHI, _EPS)
    num = dot(WF0.T, z * SPHI / (v * v))
    den = dot(WF0.T, SPHI / v)
    HF0 = HF0 * (num / jnp.maximum(den, _EPS))

    # FW
    SF0 = dot(WF0, HF0)
    v = jnp.maximum(SF0 * SPHI, _EPS)
    common = z * SF0 / (v * v)
    num = dot(WGAMMA.T, dot(common, TW.T))
    den = dot(WGAMMA.T, dot(SF0 / v, TW.T))
    FW = FW * (num / jnp.maximum(den, _EPS))
    sumFW = FW.sum(axis=0)
    sumFW_safe = jnp.where(sumFW == 0.0, 1.0, sumFW)
    FW = FW / sumFW_safe
    TW = TW * sumFW[:, None]

    # TW
    WPHI = dot(WGAMMA, FW)
    v = jnp.maximum(SF0 * dot(WPHI, TW), _EPS)
    num = dot(WPHI.T, z * SF0 / (v * v))
    den = dot(WPHI.T, SF0 / v)
    TW = TW * (num / jnp.maximum(den, _EPS))
    sumTW = TW.sum(axis=0)
    TW = jnp.where(sumTW > 0, TW / jnp.where(sumTW > 0, sumTW, 1.0), TW)
    HF0 = HF0 * sumTW[None, :]
    return HF0, FW, TW


@partial(jax.jit, static_argnames=("n_em", "n_inner"))
def _em_sf_loop(X, WF0, WGAMMA, HF00, FW0, TW0, W0, H0, R0,
                n_em: int, n_inner: int):
    # full-f32 matmuls throughout: an accelerator's reduced default precision
    # feeds the 2×2 covariance inverses enough error that the EM goes NaN
    # after a few steps (CPU computes the same graph in full f32 and is
    # stable); the context applies at trace time to every dot/einsum below
    with jax.default_matmul_precision("highest"):
        return _em_sf_loop_body(X, WF0, WGAMMA, HF00, FW0, TW0, W0, H0, R0,
                                n_em, n_inner)


def _em_sf_loop_body(X, WF0, WGAMMA, HF00, FW0, TW0, W0, H0, R0,
                     n_em: int, n_inner: int):
    XX = X[..., :, None] * jnp.conj(X)[..., None, :]       # (F,N,C,C)

    def em_step(carry, _):
        HF0, FW, TW, W, H, R = carry
        v_lead = jnp.maximum(_lead_power(WF0, WGAMMA, HF0, FW, TW), _EPS)
        v_acc = jnp.maximum(jnp.einsum("jfk,jkn->jfn", W, H), _EPS)
        v = jnp.concatenate([v_lead[None], v_acc], axis=0)  # (J,F,N)
        R_new, scale, z, nll = _spatial_estep(XX, v, R)
        # free-NMF sources absorb the spatial trace scale directly
        # (multichannel.py does the same); the lead's factors absorb it
        # implicitly by fitting z₀ — its MU targets already contain it
        W = W * scale[1:, :, None]

        def inner(_, state):
            HF0, FW, TW, W, H = state
            HF0, FW, TW = _sf_updates(z[0], WF0, WGAMMA, HF0, FW, TW)
            hat = jnp.maximum(jnp.einsum("jfk,jkn->jfn", W, H), _EPS)
            za = z[1:]
            num = jnp.einsum("jfn,jkn->jfk", za / (hat * hat), H)
            den = jnp.einsum("jfn,jkn->jfk", 1.0 / hat, H)
            W = W * (num / jnp.maximum(den, _EPS))
            sumW = jnp.maximum(W.sum(axis=1, keepdims=True), _EPS)
            W = W / sumW
            H = H * jnp.swapaxes(sumW, 1, 2)
            hat = jnp.maximum(jnp.einsum("jfk,jkn->jfn", W, H), _EPS)
            num = jnp.einsum("jfk,jfn->jkn", W, za / (hat * hat))
            den = jnp.einsum("jfk,jfn->jkn", W, 1.0 / hat)
            H = H * (num / jnp.maximum(den, _EPS))
            return HF0, FW, TW, W, H

        HF0, FW, TW, W, H = jax.lax.fori_loop(
            0, n_inner, inner, (HF0, FW, TW, W, H))
        return (HF0, FW, TW, W, H, R_new), nll

    carry0 = (HF00, FW0, TW0, W0, H0, R0)
    (HF0, FW, TW, W, H, R), nlls = jax.lax.scan(
        em_step, carry0, None, length=n_em)
    return MultichannelSF(HF0, FW, TW, W, H, R, nlls)


# posterior source images for the stacked power model — the shared
# multichannel Wiener path (one implementation for every spectral model)
_wiener_images_sf = _wiener_images_v


def model_power(model: MultichannelSF, WF0, WGAMMA) -> jnp.ndarray:
    """Stacked per-source spectral power v (J, F, N) of a fitted model."""
    v_lead = _lead_power(WF0, WGAMMA, model.HF0, model.FW, model.TW)
    v_acc = jnp.einsum("jfk,jkn->jfn", model.W, model.H)
    return jnp.concatenate([jnp.maximum(v_lead, _EPS)[None],
                            jnp.maximum(v_acc, _EPS)], axis=0)


def fit_multichannel_sf(
    X: jnp.ndarray,
    WF0: jnp.ndarray,
    WGAMMA: jnp.ndarray,
    n_acc_sources: int = 1,
    n_filters: int = 4,
    n_acc_components: int = 8,
    n_em: int = 30,
    n_inner: int = 1,
    key: jax.Array | None = None,
    HF0_init: jnp.ndarray | None = None,
    FW_init: jnp.ndarray | None = None,
    TW_init: jnp.ndarray | None = None,
    W_init: jnp.ndarray | None = None,
    H_init: jnp.ndarray | None = None,
    R_init: jnp.ndarray | None = None,
) -> MultichannelSF:
    """Fit the composed source-F0-filter multichannel model.

    X: (F, N, C) complex mixture STFT. Source 0 is the source/filter lead
    (WF0/WGAMMA fixed); sources 1..n_acc_sources are free NMF. Random
    inits follow pyfasst's ``_initialize_structures``
    (``audioModel.py:2650``: 0.75·|randn|+0.25 factors, identity-plus-
    perturbation spatial covariances).
    """
    F, N, C = X.shape
    NF0 = WF0.shape[1]
    P = WGAMMA.shape[1]
    J = 1 + n_acc_sources
    if key is None:
        key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 6)

    def init(k, shape, provided):
        if provided is not None:
            return jnp.asarray(provided, jnp.float32)
        return (0.75 * jnp.abs(jax.random.normal(k, shape)) + 0.25).astype(
            jnp.float32)

    HF0 = init(ks[0], (NF0, N), HF0_init)
    FW = init(ks[1], (P, n_filters), FW_init)
    TW = init(ks[2], (n_filters, N), TW_init)
    W = init(ks[3], (n_acc_sources, F, n_acc_components), W_init)
    H = init(ks[4], (n_acc_sources, n_acc_components, N), H_init)
    if R_init is None:
        R = random_spatial_init(ks[5], J, F, C)
    else:
        R = jnp.asarray(R_init, jnp.complex64)
    return _em_sf_loop(
        jnp.asarray(X, jnp.complex64), jnp.asarray(WF0, jnp.float32),
        jnp.asarray(WGAMMA, jnp.float32), HF0, FW, TW, W, H, R,
        int(n_em), int(n_inner))


class MultichannelLead(NamedTuple):
    """lead/accomp: (C, T) separated source images; f0: (N,) melody (Hz);
    model: the fitted composed MultichannelSF; simm: the stereo-SIMM
    warm-start result (``StereoLeadSeparation``)."""

    lead: jnp.ndarray
    accomp: jnp.ndarray
    f0: np.ndarray
    model: MultichannelSF
    simm: object


def separate_lead_multichannel(
    x: jnp.ndarray,
    sample_rate: float = 16000.0,
    n_fft: int = 1024,
    hop_length: int = 256,
    f0_min: float = 100.0,
    f0_max: float = 800.0,
    steps_per_semitone: int = 4,
    n_harmonics: int = 30,
    n_filt_atoms: int = 20,
    n_filters: int = 4,
    n_accomp: int = 40,
    n_iter_simm: int = 30,
    n_em: int = 20,
    n_acc_sources: int = 1,
    spatial_init: str = "demix",
    key: jax.Array | None = None,
) -> MultichannelLead:
    """The ``multichanLead.runDecomp`` estimation schedule
    (``audioModel.py:3060``), end to end:

    1. stereo SIMM lead/accompaniment separation
       (``separate.stereo_simm.separate_lead_stereo`` ≙ ``estimSUIMM``);
    2. spatial parameter estimation from the SEPARATED signals — DEMIX on
       the lead and accompaniment images (≙ ``demixOnSepSIMM``
       ``audioModel.py:3325``), or their empirical spatial covariances
       (``spatial_init="empirical"``);
    3. the SIMM spectral parameters + spatial estimates seed the composed
       source-F0-filter multichannel model (≙ ``initConvDemixOnSepSrc`` +
       ``setSpecCompFB``);
    4. full EM re-estimation, then spatial Wiener separation.
    """
    from exemplars_vc_tpu.separate.glue import host_stft_stack
    from exemplars_vc_tpu.separate.lead import (
        hann_filter_basis, harmonic_dictionary)
    from exemplars_vc_tpu.separate.stereo_simm import separate_lead_stereo

    x = jnp.asarray(x, jnp.float32)
    if x.ndim == 1:
        x = jnp.stack([x, x])
    C, T = x.shape
    if key is None:
        key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)

    # ---- 1. stereo SIMM warm start ----------------------------------------
    simm = separate_lead_stereo(
        x, sample_rate=sample_rate, n_fft=n_fft, hop_length=hop_length,
        f0_min=f0_min, f0_max=f0_max, steps_per_semitone=steps_per_semitone,
        n_harmonics=n_harmonics, n_filt_atoms=n_filt_atoms,
        n_filters=n_filters, n_accomp=n_accomp, n_iter=n_iter_simm, key=k1)

    from exemplars_vc_tpu.separate.glue import unit_power

    # complex glue runs jitted (separate/glue.py).
    # The composed fit runs on the UNIT-POWER STFT: its seeds (SIMM factors)
    # are estimated from unit-mean power spectra, and the raw-scale fit
    # overflows float32 on an accelerator; the Wiener masks are scale-invariant, so the
    # final images are taken from the raw X.
    X = host_stft_stack(np.asarray(x), n_fft, hop_length, fnc=True)  # (F, N, C)
    X_fit = unit_power(X)
    F, N = X.shape[0], X.shape[1]

    n_steps = int(np.ceil(
        12 * steps_per_semitone * np.log2(f0_max / f0_min))) + 1
    f0_grid = f0_min * 2.0 ** (np.arange(n_steps) / (12.0 * steps_per_semitone))
    WF0 = harmonic_dictionary(f0_grid, n_fft, sample_rate, n_harmonics)
    # the SUIMM round fitted WUF0 = [WF0, 1] (unvoiced column) — keep it
    WUF0 = jnp.concatenate([WF0, jnp.ones((F, 1), jnp.float32)], axis=1)
    WGAMMA = hann_filter_basis(F, n_filt_atoms)

    # ---- 2. spatial estimation on the separated signals -------------------
    if spatial_init == "demix" and C != 2:
        # DEMIX is stereo-only; the empirical covariance path supports any C
        spatial_init = "empirical"
    from exemplars_vc_tpu.separate.glue import first_source

    if spatial_init == "demix":
        from exemplars_vc_tpu.separate.demix import demix

        freqs = np.arange(F) / n_fft
        R_parts = []
        for img in (simm.lead, simm.accomp):
            est = demix(img, n_sources=1, n_fft=n_fft, hop_length=hop_length)
            # stays a device array end-to-end (separate/glue.py)
            R_parts.append(first_source(est.spatial_init(freqs)))
        R_lead, R_acc = R_parts
    elif spatial_init == "empirical":
        from exemplars_vc_tpu.separate.glue import empirical_spatial_cov

        R_lead = empirical_spatial_cov(simm.lead, n_fft, hop_length)
        R_acc = empirical_spatial_cov(simm.accomp, n_fft, hop_length)
    else:
        raise ValueError(f"unknown spatial_init {spatial_init!r}")

    # ---- 3+4. composed model seeded with the SIMM parameters --------------
    # the reference's nbComps is configurable (audioModel.py:2557) — the
    # SIMM accompaniment factors are split across the n_acc_sources free-NMF
    # sources (each takes a slice of WM/HM columns); all accompaniment
    # sources start at the SIMM accompaniment's spatial estimate
    m = simm.model
    J_acc = max(int(n_acc_sources), 1)
    if J_acc > n_accomp:
        raise ValueError(
            f"n_acc_sources={J_acc} exceeds n_accomp={n_accomp}: each "
            "accompaniment source needs at least one SIMM NMF component "
            "to seed from")
    k_per = max(n_accomp // J_acc, 1)
    W_seed = jnp.stack([
        m.WM[:, j * k_per : (j + 1) * k_per] for j in range(J_acc)])
    H_seed = jnp.stack([
        m.HM[j * k_per : (j + 1) * k_per] for j in range(J_acc)])
    from exemplars_vc_tpu.separate.glue import stack_spatial

    R0 = stack_spatial(R_lead, R_acc, J_acc)
    model = fit_multichannel_sf(
        X_fit, WUF0, WGAMMA,
        n_acc_sources=J_acc, n_filters=n_filters,
        n_acc_components=k_per, n_em=n_em, key=k2,
        HF0_init=m.HF0, FW_init=m.HGAMMA, TW_init=m.HPHI,
        W_init=W_seed, H_init=H_seed, R_init=R0)

    from exemplars_vc_tpu.separate.glue import images_istft

    v = model_power(model, WUF0, WGAMMA)
    Y = _wiener_images_sf(X, v, model.R)                   # (J,F,N,C)
    audio = images_istft(Y, n_fft, hop_length, T)          # (1+J_acc, C, T)

    return MultichannelLead(audio[0], audio[1:].sum(axis=0), simm.f0,
                            model, simm)

"""Stereo SIMM — pyfasst's full stereo lead/accompaniment estimator, batched.

Matches the estimation depth of the reference's vendored
``dependencies/pyfasst-master/pyfasst/SeparateLeadStereo/SIMM/SIMM.py:397``
(``Stereo_SIMM``) and its two-round driver
``SeparateLeadStereoTF.py:1408,1620`` (``estimSIMM`` → melody tracking →
VUIMM re-estimation): the Durrieu Smoothed Instantaneous Mixture Model on
BOTH channel power spectrograms jointly, with per-channel mixing parameters
estimated by damped multiplicative updates —

    ŜR = αR²·(WF0·HF0)⊙(WGAMMA·HGAMMA·HPHI) + WM·diag(βR²)·HM
    ŜL = αL²·(WF0·HF0)⊙(WGAMMA·HGAMMA·HPHI) + WM·diag(βL²)·HM

where αR/αL are the lead's instantaneous panning gains and βR/βL ∈ ℝ^R the
per-accompaniment-component panning gains. One iteration re-estimates, in
the reference's exact order: HF0, HPHI (column-normalized, scale shipped
into HF0), HM, HGAMMA (column-normalized twice, scales shipped down the
factor chain), WM (column-normalized into HM), then αR/αL and βR/βL with
the reference's 0.1·ω damping and sum-to-one renormalizations. The filter
part is the three-layer decomposition WGAMMA·HGAMMA·HPHI (smooth atom bank
× filter-shape weights × per-frame activation) — one layer deeper than the
mono ``separate.isnmf.sf_nmf`` model.

Accelerator-first: the whole iteration is a ``lax.scan`` of fused matmuls over
both channels at once; nothing leaves the device. The float64 oracle for
this module lives in ``tests/oracles/stereo_simm.py`` and the trajectory
parity test in ``tests/test_stereo_simm.py``.

``separate_lead_stereo`` is the two-round VUIMM pipeline of
``SeparateLeadStereoTF.py``: round 1 estimates all parameters (HGAMMA
free), the melody is Viterbi-decoded from HF0, round 2 re-estimates with
HF0 banded around the melody, an extra all-ones UNVOICED source column
appended to WF0 (``estimStereoSUIMMParams``: WUF0 = [WF0, 1]), and HGAMMA
frozen; per-channel Wiener masks resynthesize lead and accompaniment.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_EPS = 1e-20  # SIMM.py:498 (eps = 10**-20)


class StereoSIMM(NamedTuple):
    """Fitted stereo SIMM parameters.

    alpha: (2,) lead panning gains (R, L), summing to 1;
    HGAMMA: (P, K) filter-shape weights; HPHI: (K, N) filter activations;
    HF0: (NF0, N) source activations; beta: (2, R) accompaniment panning
    gains per component (rows sum to 1 componentwise); HM: (R, N); WM:
    (F, R); is_error: (n_iter,) IS divergence D(SXR‖ŜR)+D(SXL‖ŜL) after
    each full iteration.
    """

    alpha: jnp.ndarray
    HGAMMA: jnp.ndarray
    HPHI: jnp.ndarray
    HF0: jnp.ndarray
    beta: jnp.ndarray
    HM: jnp.ndarray
    WM: jnp.ndarray
    is_error: jnp.ndarray


def _safe(x):
    return jnp.maximum(x, _EPS)


def _colnorm(M):
    """Column-normalize where the column sum is positive; return (M, sums).

    Reference semantics (SIMM.py HPHI/HGAMMA/WM renorms): zero-sum columns
    are left untouched but the RAW sums (including zeros) are shipped into
    the downstream factor.
    """
    s = M.sum(axis=0)
    return jnp.where(s > 0, M / jnp.where(s > 0, s, 1.0), M), s


@partial(jax.jit, static_argnames=("n_iter", "omega", "update_hgamma",
                                   "update_accomp", "diag"))
def _stereo_simm_loop(SXR, SXL, WF0, WGAMMA, alpha0, HGAMMA0, HPHI0, HF00,
                      beta0, HM0, WM0, n_iter: int, omega: float,
                      update_hgamma: bool, update_accomp: bool,
                      diag: bool = False):
    # full-f32 matmuls: at an accelerator's reduced default matmul
    # precision the structured lead model underfits so badly that the free
    # accompaniment absorbs ~98% of the energy (measured). Trace-time
    # context — applies to every dot below.
    with jax.default_matmul_precision("highest"):
        return _stereo_simm_loop_body(
            SXR, SXL, WF0, WGAMMA, alpha0, HGAMMA0, HPHI0, HF00,
            beta0, HM0, WM0, n_iter, omega, update_hgamma, update_accomp,
            diag)


def _stereo_simm_loop_body(SXR, SXL, WF0, WGAMMA, alpha0, HGAMMA0, HPHI0,
                           HF00, beta0, HM0, WM0, n_iter: int, omega: float,
                           update_hgamma: bool, update_accomp: bool,
                           diag: bool = False):
    dot = partial(jnp.dot, preferred_element_type=jnp.float32)
    pw = omega          # full-power exponent for the factor updates
    pg = 0.1 * omega    # damped exponent for the mixing gains (SIMM.py:877)

    def recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM):
        SF0 = dot(WF0, HF0)
        SPHI = dot(dot(WGAMMA, HGAMMA), HPHI)
        lead = SF0 * SPHI
        accR = dot(WM * (beta[0] ** 2), HM)
        accL = dot(WM * (beta[1] ** 2), HM)
        hatR = _safe(alpha[0] ** 2 * lead + accR)
        hatL = _safe(alpha[1] ** 2 * lead + accL)
        return SF0, SPHI, lead, hatR, hatL

    def step(carry, _):
        alpha, HGAMMA, HPHI, HF0, beta, HM, WM = carry
        WPHI = dot(WGAMMA, HGAMMA)

        # ---- HF0 (SIMM.py:623-663) --------------------------------------
        SF0, SPHI, lead, hatR, hatL = recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM)
        comR = alpha[0] ** 2 * SPHI / hatR
        comL = alpha[1] ** 2 * SPHI / hatL
        num = comR * SXR / hatR + comL * SXL / hatL
        den = comR + comL
        HF0 = HF0 * (dot(WF0.T, num) / _safe(dot(WF0.T, den))) ** pw

        # ---- HPHI (SIMM.py:685-704): normalize, ship scale into HF0 -----
        SF0, SPHI, lead, hatR, hatL = recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM)
        comR = alpha[0] ** 2 * SF0 / hatR
        comL = alpha[1] ** 2 * SF0 / hatL
        num = comR * SXR / hatR + comL * SXL / hatL
        den = comR + comL
        HPHI = HPHI * (dot(WPHI.T, num) / _safe(dot(WPHI.T, den))) ** pw
        HPHI, sumHPHI = _colnorm(HPHI)
        HF0 = HF0 * sumHPHI[None, :]

        # ---- HM (SIMM.py:739-751) ---------------------------------------
        if update_accomp:
            SF0, SPHI, lead, hatR, hatL = recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM)
            WMR = WM * (beta[0] ** 2)
            WML = WM * (beta[1] ** 2)
            num = dot(WMR.T, SXR / (hatR * hatR)) + dot(WML.T, SXL / (hatL * hatL))
            den = dot(WMR.T, 1.0 / hatR) + dot(WML.T, 1.0 / hatL)
            HM = HM * (num / _safe(den)) ** pw

        # ---- HGAMMA (SIMM.py:775-800): double renorm down the chain -----
        if update_hgamma:
            SF0, SPHI, lead, hatR, hatL = recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM)
            comR = alpha[0] ** 2 * SF0 / hatR
            comL = alpha[1] ** 2 * SF0 / hatL
            num = comR * SXR / hatR + comL * SXL / hatL
            den = comR + comL
            HGAMMA = HGAMMA * (
                dot(WGAMMA.T, dot(num, HPHI.T))
                / _safe(dot(WGAMMA.T, dot(den, HPHI.T)))
            ) ** pw
            HGAMMA, sumHG = _colnorm(HGAMMA)
            HPHI = HPHI * sumHG[:, None]
            HPHI, sumHPHI = _colnorm(HPHI)
            HF0 = HF0 * sumHPHI[None, :]

        # ---- WM (SIMM.py:826-846): normalize, ship into HM --------------
        if update_accomp:
            SF0, SPHI, lead, hatR, hatL = recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM)
            num = (dot(SXR / (hatR * hatR), HM.T * (beta[0] ** 2)[None, :])
                   + dot(SXL / (hatL * hatL), HM.T * (beta[1] ** 2)[None, :]))
            den = (dot(1.0 / hatR, HM.T * (beta[0] ** 2)[None, :])
                   + dot(1.0 / hatL, HM.T * (beta[1] ** 2)[None, :]))
            WM = WM * (num / _safe(den)) ** pw
            WM, sumWM = _colnorm(WM)
            HM = HM * sumWM[:, None]

        # ---- alphaR/alphaL (SIMM.py:871-884): damped, sum-to-one --------
        SF0, SPHI, lead, hatR, hatL = recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM)
        denR = lead / hatR
        aR = jnp.maximum(
            alpha[0] * (jnp.sum(denR * SXR / hatR) / jnp.sum(denR)) ** pg, _EPS)
        denL = lead / hatL
        aL = jnp.maximum(
            alpha[1] * (jnp.sum(denL * SXL / hatL) / jnp.sum(denL)) ** pg, _EPS)
        aR = aR / jnp.maximum(aR + aL, 1e-3)
        alpha = jnp.stack([aR, 1.0 - aR])

        # ---- betaR/betaL (SIMM.py:908-920): per-component, damped -------
        if update_accomp:
            SF0, SPHI, lead, hatR, hatL = recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM)
            # diag(WMᵀ A HMᵀ)_r = Σ_f Σ_n WM[f,r]·A[f,n]·HM[r,n] — one einsum
            numR = jnp.einsum("fr,fn,rn->r", WM, SXR / (hatR * hatR), HM)
            denR = jnp.einsum("fr,fn,rn->r", WM, 1.0 / hatR, HM)
            bR = beta[0] * (numR / _safe(denR)) ** pg
            numL = jnp.einsum("fr,fn,rn->r", WM, SXL / (hatL * hatL), HM)
            denL = jnp.einsum("fr,fn,rn->r", WM, 1.0 / hatL, HM)
            bL = beta[1] * (numL / _safe(denL)) ** pg
            bR = bR / _safe(bR + bL)
            beta = jnp.stack([bR, 1.0 - bR])

        # ---- IS reconstruction error after the full iteration -----------
        SF0, SPHI, lead, hatR, hatL = recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM)
        rR = SXR / hatR
        rL = SXL / hatL
        err = (jnp.sum(rR - jnp.log(_safe(rR)) - 1.0)
               + jnp.sum(rL - jnp.log(_safe(rL)) - 1.0))

        out = err
        if diag:
            lead_pow = (alpha[0] ** 2 + alpha[1] ** 2) * jnp.sum(lead)
            tot = jnp.sum(hatR) + jnp.sum(hatL)
            out = {
                "err": err,
                "alpha_r": alpha[0],
                "lead_share": lead_pow / _safe(tot),
                "sum_hf0": jnp.sum(HF0),
                "sum_hphi": jnp.sum(HPHI),
                "sum_hgamma": jnp.sum(HGAMMA),
                "sum_hm": jnp.sum(HM),
                "sum_wm": jnp.sum(WM),
                "min_hat": jnp.minimum(jnp.min(hatR), jnp.min(hatL)),
                "max_hat": jnp.maximum(jnp.max(hatR), jnp.max(hatL)),
                "min_lead": jnp.min(lead),
                "max_hf0": jnp.max(HF0),
            }
        return (alpha, HGAMMA, HPHI, HF0, beta, HM, WM), out

    carry0 = (alpha0, HGAMMA0, HPHI0, HF00, beta0, HM0, WM0)
    (alpha, HGAMMA, HPHI, HF0, beta, HM, WM), outs = jax.lax.scan(
        step, carry0, None, length=n_iter)
    if diag:
        return StereoSIMM(alpha, HGAMMA, HPHI, HF0, beta, HM, WM,
                          outs["err"]), outs
    return StereoSIMM(alpha, HGAMMA, HPHI, HF0, beta, HM, WM, outs)


def stereo_simm(
    SXR: jnp.ndarray,
    SXL: jnp.ndarray,
    WF0: jnp.ndarray,
    WGAMMA: jnp.ndarray,
    n_filters: int = 4,
    n_accomp: int = 10,
    n_iter: int = 30,
    omega: float = 1.0,
    update_hgamma: bool = True,
    update_accomp: bool = True,
    HGAMMA_init: jnp.ndarray | None = None,
    HPHI_init: jnp.ndarray | None = None,
    HF0_init: jnp.ndarray | None = None,
    WM_init: jnp.ndarray | None = None,
    HM_init: jnp.ndarray | None = None,
    beta_init: jnp.ndarray | None = None,
    alpha_init: jnp.ndarray | None = None,
    key: jax.Array | None = None,
    return_diagnostics: bool = False,
) -> StereoSIMM:
    """Fit the stereo SIMM to the two channel power spectrograms.

    SXR/SXL: (F, N) right/left power spectrograms. WF0: (F, NF0) fixed
    source dictionary. WGAMMA: (F, P) fixed smooth filter-atom bank.
    Inits follow the reference (|randn| factors, α=(0.5, 0.5), βR uniform
    random with βL = 1−βR — ``SIMM.py:524-583``).
    """
    F, N = SXR.shape
    NF0 = WF0.shape[1]
    P = WGAMMA.shape[1]
    if key is None:
        key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 6)

    def init(k, shape, provided):
        if provided is not None:
            return jnp.asarray(provided, jnp.float32)
        return jnp.abs(jax.random.normal(k, shape)).astype(jnp.float32)

    HGAMMA = init(ks[0], (P, n_filters), HGAMMA_init)
    HPHI = init(ks[1], (n_filters, N), HPHI_init)
    HF0 = init(ks[2], (NF0, N), HF0_init)
    WM = init(ks[3], (F, n_accomp), WM_init)
    HM = init(ks[4], (n_accomp, N), HM_init)
    if beta_init is None:
        bR = jax.random.uniform(ks[5], (n_accomp,), dtype=jnp.float32)
        beta = jnp.stack([bR, 1.0 - bR])
    else:
        beta = jnp.asarray(beta_init, jnp.float32)
    alpha = (jnp.array([0.5, 0.5], jnp.float32) if alpha_init is None
             else jnp.asarray(alpha_init, jnp.float32))
    return _stereo_simm_loop(
        jnp.asarray(SXR, jnp.float32), jnp.asarray(SXL, jnp.float32),
        jnp.asarray(WF0, jnp.float32), jnp.asarray(WGAMMA, jnp.float32),
        alpha, HGAMMA, HPHI, HF0, beta, HM, WM,
        int(n_iter), float(omega), bool(update_hgamma), bool(update_accomp),
        bool(return_diagnostics))


class StereoLeadSeparation(NamedTuple):
    """lead/accomp: (2, T) stereo source estimates; f0: (N,) melody (Hz, 0
    where unvoiced); model: the round-2 fitted StereoSIMM; f0_candidates:
    the candidate grid."""

    lead: jnp.ndarray
    accomp: jnp.ndarray
    f0: np.ndarray
    f0_candidates: np.ndarray
    model: StereoSIMM


def separate_lead_stereo(
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
    n_iter: int = 30,
    n_warmup: int = 10,
    melody_halfwidth_semitones: float = 0.5,
    transition_scale: float = 10.0,
    voicing_threshold: float = 0.05,
    key: jax.Array | None = None,
) -> StereoLeadSeparation:
    """Two-round stereo VUIMM lead separation (``SeparateLeadStereoTF.py``).

    Round 1 (``estimStereoSIMMParams``): full stereo SIMM fit, HGAMMA free.
    Melody: Viterbi decoding over round-1 HF0 (the ``_tracking`` kernel →
    ``align.viterbi`` here). Round 2 (``estimStereoSUIMMParams``): WF0 is
    extended with an all-ones UNVOICED column, HF0 re-initialized banded
    ±``melody_halfwidth_semitones`` around the melody with the unvoiced row
    set to 1, HGAMMA frozen at round 1's estimate, HPHI/WM/HM fresh.
    Per-channel Wiener masks (lead share of each channel's model power)
    resynthesize the stereo lead and accompaniment images.
    """
    from exemplars_vc_tpu.separate.glue import (
        host_stereo_powers, host_stft_stack, masked_istft)
    from exemplars_vc_tpu.separate.lead import (
        _track_melody, hann_filter_basis, harmonic_dictionary,
        melody_transition)

    x_np = np.asarray(x, np.float32)
    if x_np.ndim == 1:
        x_np = np.stack([x_np, x_np])
    x = jnp.asarray(x_np)
    C, T = x.shape
    # complex glue runs jitted (separate/glue.py);
    # unit-mean power scaling: the IS model is scale-covariant and the
    # Wiener masks scale-invariant, but the float32 factor chain overflows
    # on raw power values (the reference runs float64 on host). The model
    # input power itself is computed HOST-side in float64 — platform-exact
    # SIMM conditioning (glue._host_stft_power).
    X = host_stft_stack(x_np, n_fft, hop_length, fnc=False)  # (C, F, N)
    SXR, SXL = (jnp.asarray(a)
                for a in host_stereo_powers(x_np, n_fft, hop_length))
    F, N = SXR.shape

    n_steps = int(np.ceil(12 * steps_per_semitone * np.log2(f0_max / f0_min))) + 1
    f0_grid = f0_min * 2.0 ** (np.arange(n_steps) / (12.0 * steps_per_semitone))
    WF0 = harmonic_dictionary(f0_grid, n_fft, sample_rate, n_harmonics)
    WGAMMA = hann_filter_basis(F, n_filt_atoms)
    if key is None:
        key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)

    # ---- round 1: voiced-only SIMM, all parameters free ------------------
    # Warm-up with the accompaniment FROZEN near zero first, as in the mono
    # path (`separate.lead.separate_lead`): under IS multiplicative updates
    # an unconstrained residual otherwise absorbs the harmonic energy the
    # structured lead model should claim.
    tiny_WM = jnp.full((F, n_accomp), 1e-3, jnp.float32)
    tiny_HM = jnp.full((n_accomp, N), 1e-3, jnp.float32)
    warm = {}
    if n_warmup > 0:
        w = stereo_simm(
            SXR, SXL, WF0, WGAMMA, n_filters=n_filters, n_accomp=n_accomp,
            n_iter=n_warmup, update_hgamma=True, update_accomp=False,
            WM_init=tiny_WM, HM_init=tiny_HM, key=k1)
        warm = dict(HGAMMA_init=w.HGAMMA, HPHI_init=w.HPHI,
                    HF0_init=w.HF0, alpha_init=w.alpha)
    m1 = stereo_simm(
        SXR, SXL, WF0, WGAMMA, n_filters=n_filters, n_accomp=n_accomp,
        n_iter=n_iter, update_hgamma=True, key=k1, **warm)

    # ---- melody decoding --------------------------------------------------
    log_trans = melody_transition(f0_grid, transition_scale)
    path = _track_melody(m1.HF0, log_trans)                # (N,)

    # ---- round 2: VUIMM — banded HF0 + unvoiced column, HGAMMA frozen ----
    WUF0 = jnp.concatenate([WF0, jnp.ones((F, 1), jnp.float32)], axis=1)
    half = melody_halfwidth_semitones * steps_per_semitone
    cand = jnp.arange(n_steps, dtype=jnp.float32)
    band = (jnp.abs(cand[:, None] - path[None, :].astype(jnp.float32))
            <= half).astype(jnp.float32)
    HUF0 = jnp.concatenate(
        [m1.HF0 * band, jnp.ones((1, N), jnp.float32)], axis=0)
    # the round-1 accompaniment already absorbed part of the melody's
    # harmonic energy; restart it tiny so the banded lead reclaims it
    # (measured +5 dB lead SNR in the mono path — same schedule here)
    m2 = stereo_simm(
        SXR, SXL, WUF0, WGAMMA, n_filters=n_filters, n_accomp=n_accomp,
        n_iter=n_iter, update_hgamma=False,
        HGAMMA_init=m1.HGAMMA, HF0_init=HUF0, alpha_init=m1.alpha,
        WM_init=tiny_WM, HM_init=tiny_HM, key=k2)

    # ---- per-channel Wiener masks + resynthesis ---------------------------
    dot = partial(jnp.dot, preferred_element_type=jnp.float32)
    lead_pow = dot(WUF0, m2.HF0) * dot(dot(WGAMMA, m2.HGAMMA), m2.HPHI)
    accR = dot(m2.WM * (m2.beta[0] ** 2), m2.HM)
    accL = dot(m2.WM * (m2.beta[1] ** 2), m2.HM)
    leadR = m2.alpha[0] ** 2 * lead_pow
    leadL = m2.alpha[1] ** 2 * lead_pow
    gR = leadR / jnp.maximum(leadR + accR, _EPS)
    gL = leadL / jnp.maximum(leadL + accL, _EPS)
    gain = jnp.stack([gR, gL]) if C == 2 else gR[None]
    lead, accomp = masked_istft(X, gain, n_fft, hop_length, T, fnc=False)

    # voicing: fraction of model power the VOICED lead rows carry
    voiced_pow = (m2.alpha[0] ** 2 + m2.alpha[1] ** 2) * jnp.sum(
        dot(WUF0[:, :-1], m2.HF0[:-1])
        * dot(dot(WGAMMA, m2.HGAMMA), m2.HPHI), axis=0)
    tot = jnp.maximum(
        jnp.sum(leadR + leadL + accR + accL, axis=0), _EPS)
    voiced = np.asarray(voiced_pow / tot) > voicing_threshold
    f0 = np.where(voiced, f0_grid[np.asarray(path)], 0.0)

    return StereoLeadSeparation(lead, accomp, f0, f0_grid, m2)

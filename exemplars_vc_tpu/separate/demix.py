"""DEMIX spatial clustering — anechoic mixing-direction estimation, batched.

Covers the capability of the reference's vendored pyfasst DEMIX module
(``dependencies/pyfasst-master/pyfasst/demixTF.py``: ``class DEMIX`` :106,
``comp_pcafeatures`` :448, ``comp_clusters`` :155, ``identify_deltaT`` :274,
``steeringVectorsFromCentroids`` :905): estimate the number of sources in a
stereo (or C-channel) mixture and, for each source, its mixing direction —
a pan angle θ (relative channel gain) and an inter-channel delay δ — by
clustering time-frequency points whose local spatial covariance is close to
rank 1.

Batched re-design (pyfasst loops over TF points on host and grows Python
cluster objects point by point):

- local spatial covariances for ALL TF bins at once via a separable box
  smoothing of the outer-product spectrogram (two small matmul-shaped
  convolutions);
- closed-form 2×2 Hermitian eigen-decomposition per bin (pure elementwise math, no
  linalg kernel), giving each TF point a principal direction and a DEMIX
  confidence = principal-to-residual eigenvalue ratio (``demixTF.py``'s
  ``confidenceFromVar`` is the same quantity transformed);
- clustering as one confidence-weighted histogram over θ (a ``bincount``)
  with host-side peak picking (a few dozen scalars — orchestration-side
  numpy per the design invariants), then a fixed-iteration weighted
  refinement of each centroid on device;
- per-cluster delay by scoring a static candidate-delay grid against the
  confidence-weighted inter-channel phases: one complex matmul
  (points × delays), the batched shape of DEMIX's ``identify_deltaT`` zoomed
  cross-correlation search.

The estimated directions convert to steering vectors / rank-1 spatial
covariances that initialize :func:`~exemplars_vc_tpu.separate.multichannel.
fit_multichannel_nmf` (pyfasst's own use: DEMIX anechoic parameters seed the
FASST mixing model).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_EPS = 1e-12


class DemixEstimate(NamedTuple):
    """Estimated anechoic mixing parameters for J sources (stereo).

    theta: (J,) pan angles in [0, π/2] — direction [cosθ, sinθ];
    delay: (J,) inter-channel delays in SAMPLES (channel 1 relative to 0);
    weight: (J,) total cluster confidence mass (sorted descending);
    hist: (n_bins,) the confidence-weighted θ histogram (diagnostics).
    """

    theta: np.ndarray
    delay: np.ndarray
    weight: np.ndarray
    hist: np.ndarray

    def steering_vectors(self, freqs: np.ndarray) -> jnp.ndarray:
        """Anechoic steering vectors a_j(f) — (J, F, 2) complex64.

        freqs: (F,) frequencies in CYCLES PER SAMPLE (bin / n_fft);
        a_j(f) = [cosθ_j, sinθ_j · e^{-i2πf δ_j}]  (pyfasst
        ``steeringVectorsFromCentroids``, ``demixTF.py:905-943``).
        Runs as one jitted program — eager complex ops are unimplemented on
        this backend (separate/glue.py)."""
        from exemplars_vc_tpu.separate.glue import anechoic_steering

        return anechoic_steering(jnp.asarray(self.theta, jnp.float32),
                                 jnp.asarray(self.delay, jnp.float32),
                                 jnp.asarray(freqs, jnp.float32))

    def spatial_init(self, freqs: np.ndarray, diffuse: float = 0.05) -> jnp.ndarray:
        """Rank-1-plus-diffuse spatial covariances R_j(f) — (J, F, 2, 2).

        ``R_j = (1−diffuse)·a_j a_jᴴ·C/‖a_j‖² + diffuse·I`` — the DEMIX
        anechoic model regularized so EM can still move (a pure rank-1 init
        is a fixed point of zero-variance directions).
        """
        from exemplars_vc_tpu.separate.glue import steering_to_spatial

        return steering_to_spatial(self.steering_vectors(freqs),
                                   jnp.float32(diffuse))


def _box_smooth(M: jnp.ndarray, kf: int, kn: int) -> jnp.ndarray:
    """Separable box filter over the leading two axes (F, N, ...) of M."""
    def smooth_axis(x, k, axis):
        if k <= 1:
            return x
        kern = jnp.ones((k,), x.dtype) / k
        pad = [(0, 0)] * x.ndim
        pad[axis] = (k // 2, (k - 1) // 2)
        xp = jnp.pad(x, pad, mode="edge")
        xm = jnp.moveaxis(xp, axis, -1)
        sh = xm.shape
        y = jax.vmap(lambda row: jnp.convolve(row, kern, mode="valid"))(
            xm.reshape(-1, sh[-1])
        ).reshape(sh[:-1] + (sh[-1] - k + 1,))
        return jnp.moveaxis(y, -1, axis)

    return smooth_axis(smooth_axis(M, kf, 0), kn, 1)


@partial(jax.jit, static_argnames=("kf", "kn", "n_bins"))
def _tf_features(X: jnp.ndarray, kf: int, kn: int, n_bins: int):
    """Per-TF-bin direction features from a stereo STFT X (F, N, 2).

    Returns (theta, phase, conf, hist): θ ∈ [0, π/2] principal-direction pan
    angle, inter-channel phase at the bin, DEMIX confidence (principal /
    residual local-variance ratio, log-scaled), and the confidence-weighted
    θ histogram over ``n_bins`` bins.
    """
    # local spatial covariance: smoothed outer products (F, N, 2, 2)
    XX = X[..., :, None] * jnp.conj(X)[..., None, :]
    Rloc = _box_smooth(XX, kf, kn)

    a = jnp.real(Rloc[..., 0, 0])
    d = jnp.real(Rloc[..., 1, 1])
    b = Rloc[..., 0, 1]
    # 2×2 Hermitian eigenvalues: λ = (a+d)/2 ± sqrt(((a−d)/2)² + |b|²)
    half = 0.5 * (a + d)
    disc = jnp.sqrt(jnp.maximum(0.25 * (a - d) ** 2 + jnp.abs(b) ** 2, 0.0))
    lam1 = half + disc
    lam2 = jnp.maximum(half - disc, 0.0)
    # principal eigenvector (up to phase): v ∝ [b, λ1 − a]
    v0 = jnp.abs(b)
    v1 = lam1 - a
    # fully degenerate bins (v0 = v1 = 0) land at θ = 0 with ~zero confidence
    theta = jnp.arctan2(jnp.maximum(v1, 0.0), jnp.maximum(v0, _EPS))
    # inter-channel phase of the principal direction: arg conj(b) = arg E[x̄0 x1]
    # = −2πfδ for a source delayed by δ samples on channel 1
    phase = jnp.angle(jnp.conj(b) + _EPS)

    # DEMIX confidence: how rank-1 the local covariance is, weighted by power
    # (demixTF.py:448-476 comp_pcafeatures / :92 confidenceFromVar)
    conf = jnp.log1p(lam1 / jnp.maximum(lam2, _EPS * jnp.maximum(lam1, _EPS))) \
        * jnp.log1p(lam1 / jnp.maximum(jnp.mean(lam1), _EPS))

    idx = jnp.clip(
        (theta / (0.5 * jnp.pi) * n_bins).astype(jnp.int32), 0, n_bins - 1
    )
    hist = jnp.zeros((n_bins,), jnp.float32).at[idx.ravel()].add(conf.ravel())
    return theta, phase, conf, hist


@partial(jax.jit, static_argnames=("n_refine",))
def _refine_centroids(theta, conf, cents, width, n_refine: int):
    """Fixed-iteration weighted mean-shift of θ centroids (J,)."""
    th = theta.ravel()
    w = conf.ravel()

    def body(_, c):
        # soft membership: within ±width of each centroid
        m = (jnp.abs(th[None, :] - c[:, None]) < width).astype(jnp.float32) * w
        num = m @ th
        den = jnp.maximum(m.sum(axis=1), _EPS)
        return num / den

    return jax.lax.fori_loop(0, n_refine, body, cents)


@jax.jit
def _delay_scores(theta, phase, conf, freqs, cents, width, delays):
    """Score candidate delays per cluster: (J, D) coherence.

    score[j, d] = Σ_{bins near θ_j} conf · cos(phase + 2π f δ_d) — maximal
    where the candidate cancels the measured −2πfδ phase ramp; computed as
    the real part of one (J·points)×(D) complex contraction, the matmul
    form of DEMIX's cross-correlation delay search (demixTF.py:274-351).
    """
    th = theta.ravel()
    w = conf.ravel()
    ph = phase.ravel()
    f = freqs.ravel()
    member = (jnp.abs(th[None, :] - cents[:, None]) < width).astype(jnp.float32)
    z = (w * jnp.exp(1j * ph)).astype(jnp.complex64)            # (P,)
    basis = jnp.exp(2j * jnp.pi * f[:, None] * delays[None, :])  # (P, D)
    return jnp.real((member * z[None, :]) @ basis)                # (J, D)


def demix(
    x: jnp.ndarray,
    n_sources: int | None = None,
    n_fft: int = 1024,
    hop_length: int = 256,
    neighborhood: tuple[int, int] = (3, 3),
    n_bins: int = 90,
    max_sources: int = 8,
    peak_rel_threshold: float = 0.2,
    max_delay: float = 8.0,
    n_delays: int = 129,
    n_refine: int = 4,
) -> DemixEstimate:
    """Estimate anechoic mixing directions of a stereo mixture x (2, T).

    The DEMIX pipeline (``demixTF.py:106-943``) re-shaped for batched accelerators: STFT →
    batched local-covariance PCA features → confidence-weighted θ histogram
    → peak picking (host, ``n_sources=None`` keeps peaks above
    ``peak_rel_threshold``·max as pyfasst's adaptive thresholding does;
    otherwise the top-``n_sources``) → device centroid refinement → one
    matmul delay search per cluster over ±``max_delay`` samples.
    """
    from exemplars_vc_tpu.separate.glue import stft_stack

    x = jnp.asarray(x, jnp.float32)
    if x.ndim != 2 or x.shape[0] != 2:
        raise ValueError(f"demix expects a stereo signal (2, T), got {x.shape}")
    # complex glue runs jitted (separate/glue.py)
    X = stft_stack(x, n_fft, hop_length, fnc=True)       # (F, N, 2)
    kf, kn = neighborhood

    theta, phase, conf, hist = _tf_features(X, kf, kn, n_bins)
    hist_np = np.asarray(hist)

    # ---- host-side peak picking on the tiny histogram ----------------------
    ext = np.concatenate([[hist_np[0] - 1], hist_np, [hist_np[-1] - 1]])
    is_peak = (hist_np >= ext[:-2]) & (hist_np >= ext[2:])
    peak_idx = np.nonzero(is_peak)[0]
    peak_val = hist_np[peak_idx]
    order = np.argsort(-peak_val)
    peak_idx, peak_val = peak_idx[order], peak_val[order]
    if n_sources is None:
        keep = peak_val >= peak_rel_threshold * (peak_val[0] if len(peak_val) else 1.0)
        peak_idx, peak_val = peak_idx[keep][:max_sources], peak_val[keep][:max_sources]
    else:
        # merge adjacent-bin duplicates before truncating
        dedup: list[int] = []
        for i in peak_idx:
            if all(abs(i - j) > 1 for j in dedup):
                dedup.append(int(i))
            if len(dedup) == n_sources:
                break
        peak_idx = np.asarray(dedup, np.int64)
        peak_val = hist_np[peak_idx]
        if len(peak_idx) < n_sources:
            # fewer distinct histogram peaks than requested sources: fill
            # with evenly spaced angles so the caller always gets n_sources
            fill = np.linspace(0, n_bins - 1, n_sources - len(peak_idx) + 2,
                               dtype=np.int64)[1:-1]
            peak_idx = np.concatenate([peak_idx, fill])[:n_sources]
            peak_val = hist_np[peak_idx]
    if len(peak_idx) == 0:
        peak_idx, peak_val = np.asarray([n_bins // 2]), np.asarray([1.0])

    cents0 = (peak_idx.astype(np.float32) + 0.5) / n_bins * (0.5 * np.pi)
    width = jnp.float32(0.5 * np.pi / n_bins * 3.0)
    cents = _refine_centroids(theta, conf, jnp.asarray(cents0), width, n_refine)

    # ---- per-cluster delay over a static candidate grid ---------------------
    F = X.shape[0]
    freqs_bc = jnp.broadcast_to(
        (jnp.arange(F, dtype=jnp.float32) / n_fft)[:, None], theta.shape
    )
    delays = jnp.linspace(-max_delay, max_delay, n_delays, dtype=jnp.float32)
    scores = _delay_scores(theta, phase, conf, freqs_bc, cents, width, delays)
    best = jnp.argmax(scores, axis=1)
    delay = np.asarray(delays)[np.asarray(best)]

    # total confidence mass per cluster, for ranking
    th = np.asarray(theta).ravel()
    w = np.asarray(conf).ravel()
    cents_np = np.asarray(cents)
    mass = np.array([
        w[np.abs(th - c) < float(width)].sum() for c in cents_np
    ])
    order = np.argsort(-mass)
    return DemixEstimate(
        theta=cents_np[order],
        delay=np.asarray(delay)[order],
        weight=mass[order],
        hist=hist_np,
    )

"""HMM spectral models for separation — pyfasst's MultiChanHMM, batched.

Covers the reference's vendored pyfasst HMM time-constraint capability
(``dependencies/pyfasst-master/pyfasst/audioModel.py``: ``MultiChanHMM``
:2510-2550 — ``makeItHMM``/``makeItSHMM`` — applied inside the GEM iteration
at ``audioModel.py:1728-1930``): a source's spectral power is constrained to
ONE active spectral state per frame, v_j(f, n) = W_j[f, s_j(n)], with the
state sequence decoded by min-sum Viterbi over per-frame Itakura-Saito
costs plus −log transition penalties, and (for the 'free' prior) the
transition matrix re-estimated from transition counts. 'SHMM' is the same
with a fixed sticky transition prior (pyfasst uses 0.9 self-transition).

Batched re-design (pyfasst loops states and frames in host numpy):

- the whole per-state cost matrix is two matmuls (Σ_f z/w is (1/W)ᵀ·Z; the
  log terms are rank-1) — no per-state loop;
- Viterbi is the batched ``align.viterbi.viterbi_track`` scan (the same DP
  family as pyfasst's Cython ``viterbiTracking``);
- one-hot state indicators make every M-step quantity a matmul: state
  spectra are V·Pᵀ/counts (the IS-optimal per-state mean), transition
  counts are P[:, :-1]·P[:, 1:]ᵀ;
- the multichannel variant reuses the exact FASST spatial E-step from
  ``separate.multichannel`` and swaps only the spectral M-step.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from exemplars_vc_tpu.align.viterbi import viterbi_track
from exemplars_vc_tpu.separate.multichannel import (
    MultichannelNMF,
    _spatial_estep,
)

_EPS = 1e-10


class HMMSpectra(NamedTuple):
    """Fitted single-channel HMM spectral model.

    W: (F, S) per-state spectra; states: (N,) int32 decoded path;
    A: (S, S) transition matrix (rows sum to 1); cost: (n_iter,) total
    decoded IS divergence per iteration.
    """

    W: jnp.ndarray
    states: jnp.ndarray
    A: jnp.ndarray
    cost: jnp.ndarray


def _is_cost_matrix(V, W):
    """IS-divergence cost of explaining each frame with each single state.

    V: (F, N) observed power; W: (F, S) state spectra. Returns (S, N):
    cost[s, n] = Σ_f V[f,n]/W[f,s] − log V[f,n] + log W[f,s] − 1
    (``audioModel.py:1816-1830`` computes exactly this ratio sum per state).
    """
    F = V.shape[0]
    ratio = jnp.maximum(W, _EPS).T  # (S, F)
    cost = jnp.dot(1.0 / ratio, V, preferred_element_type=jnp.float32)
    cost = cost - jnp.sum(jnp.log(jnp.maximum(V, _EPS)), axis=0)[None, :]
    cost = cost + jnp.sum(jnp.log(jnp.maximum(W, _EPS)), axis=0)[:, None]
    return cost - F


def _decode(V, W, A):
    """Viterbi state path minimizing IS cost − log transitions: (N,) int32."""
    S = W.shape[1]
    cost = _is_cost_matrix(V, W)
    log_prior = jnp.full((S,), -jnp.log(S), jnp.float32)
    path = viterbi_track(-cost, log_prior, jnp.log(jnp.maximum(A, _EPS)))
    frame_cost = jnp.take_along_axis(cost, path[None, :], axis=0).sum()
    return path, frame_cost


def _count_transitions(P, A_prev):
    """Row-normalized transition counts; rows with no visits keep A_prev.

    P: (S, N) one-hot state indicators. Matches the 'free'-prior update at
    ``audioModel.py:1903-1925`` (rows with zero antecedent count are left
    unchanged).
    """
    counts = jnp.dot(P[:, :-1], P[:, 1:].T, preferred_element_type=jnp.float32)
    row = counts.sum(axis=1, keepdims=True)
    A = jnp.where(row > 0, counts / jnp.maximum(row, _EPS), A_prev)
    return A


def sticky_transition(n_states: int, stickiness: float = 9.0) -> jnp.ndarray:
    """pyfasst's SHMM prior: (9·I + 1) row-normalized (audioModel.py:2534-2547)."""
    A = stickiness * jnp.eye(n_states, dtype=jnp.float32) + 1.0
    return A / A.sum(axis=1, keepdims=True)


@partial(jax.jit, static_argnames=("n_iter", "update_transition"))
def _hmm_fit_loop(V, W0, A0, n_iter: int, update_transition: bool):
    S = W0.shape[1]

    def body(carry, _):
        W, A = carry
        path, frame_cost = _decode(V, W, A)
        P = jax.nn.one_hot(path, S, dtype=jnp.float32).T          # (S, N)
        counts = P.sum(axis=1)                                     # (S,)
        W_new = jnp.dot(V, P.T, preferred_element_type=jnp.float32)
        W_new = jnp.where(
            counts[None, :] > 0, W_new / jnp.maximum(counts, _EPS)[None, :], W
        )
        if update_transition:
            A = _count_transitions(P, A)
        return (W_new, A), frame_cost

    (W, A), costs = jax.lax.scan(body, (W0, A0), None, length=n_iter)
    path, _ = _decode(V, W, A)
    return W, path, A, costs


def fit_hmm_spectra(
    V: jnp.ndarray,
    n_states: int = 4,
    n_iter: int = 20,
    transition: jnp.ndarray | None = None,
    update_transition: bool = True,
    W_init: jnp.ndarray | None = None,
) -> HMMSpectra:
    """Fit an HMM spectral model to a power spectrogram V (F, N).

    Each frame is explained by exactly one state spectrum (IS divergence);
    segmentation by Viterbi with transition penalties. ``update_transition=
    False`` with ``transition=sticky_transition(S)`` is pyfasst's SHMM
    ('fixed' prior); the default is HMM with the 'free' count-based update.
    Deterministic init: W_init defaults to S evenly spaced FRAMES of V
    (distinct seeds, k-means style — per-segment means would collapse the
    states toward the global mean and wedge the one-hot reassignment).
    """
    V = jnp.asarray(V, jnp.float32)
    F, N = V.shape
    S = n_states
    if W_init is None:
        idx = jnp.linspace(0, N - 1, S).round().astype(jnp.int32)
        W_init = V[:, idx]
    A0 = sticky_transition(S) if transition is None else jnp.asarray(
        transition, jnp.float32
    )
    W, path, A, costs = _hmm_fit_loop(
        V, jnp.asarray(W_init, jnp.float32), A0, n_iter, update_transition
    )
    return HMMSpectra(W, path, A, costs)


# ---------------------------------------------------------------------------
# Multichannel: FASST spatial E-step + HMM spectral M-step (MultiChanHMM)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("n_em", "update_transition"))
def _em_loop_hmm(X, W0, P0, A0, R0, n_em: int, update_transition: bool):
    S = W0.shape[-1]
    XX = X[..., :, None] * jnp.conj(X)[..., None, :]

    def em_step(carry, _):
        W, P, A, R = carry
        v = jnp.maximum(jnp.einsum("jfs,jsn->jfn", W, P), _EPS)
        R_new, scale, z, nll = _spatial_estep(XX, v, R)
        W = W * scale[..., None]

        def per_source(zj, Wj, Aj, Pj):
            path, _ = _decode(zj, Wj, Aj)
            Pj_new = jax.nn.one_hot(path, S, dtype=jnp.float32).T
            counts = Pj_new.sum(axis=1)
            Wj_new = jnp.dot(zj, Pj_new.T, preferred_element_type=jnp.float32)
            Wj_new = jnp.where(
                counts[None, :] > 0,
                Wj_new / jnp.maximum(counts, _EPS)[None, :],
                Wj,
            )
            if update_transition:
                Aj = _count_transitions(Pj_new, Aj)
            return Wj_new, Pj_new, Aj

        W, P, A = jax.vmap(per_source)(z, W, A, P)
        return (W, P, A, R_new), nll

    (W, P, A, R), nlls = jax.lax.scan(em_step, (W0, P0, A0, R0), None, length=n_em)
    return W, P, A, R, nlls


def fit_multichannel_hmm(
    X: jnp.ndarray,
    n_sources: int = 2,
    n_states: int = 4,
    n_em: int = 50,
    sticky: bool = False,
    key: jax.Array | None = None,
    R_init: jnp.ndarray | None = None,
) -> MultichannelNMF:
    """Fit the multichannel HMM local Gaussian model to a mixture STFT.

    ≙ pyfasst ``MultiChanHMM`` (``audioModel.py:2510``) with ``makeItHMM``
    (``sticky=False``: free count-based transition updates) or ``makeItSHMM``
    (``sticky=True``: fixed sticky prior). X: (F, N, C) complex. Returns a
    :class:`~exemplars_vc_tpu.separate.multichannel.MultichannelNMF` whose H
    is the (J, S, N) one-hot state-indicator matrix — so every downstream
    consumer (``_wiener_images``, ``separate_signal``'s ISTFT path) works
    unchanged: v_j = W_j · H_j holds for the HMM model too.
    """
    F, N, C = X.shape
    J, S = n_sources, n_states
    if key is None:
        key = jax.random.PRNGKey(0)
    kw, kr, kp = jax.random.split(key, 3)
    W0 = jax.random.normal(kw, (J, F, S)) ** 2
    # random initial state paths (distinct per source so sources differ)
    paths0 = jax.random.randint(kp, (J, N), 0, S)
    P0 = jax.nn.one_hot(paths0, S, dtype=jnp.float32).transpose(0, 2, 1)
    A0 = jnp.broadcast_to(
        sticky_transition(S) if sticky else jnp.full((S, S), 1.0 / S), (J, S, S)
    ).astype(jnp.float32)
    if R_init is None:
        a = jax.random.normal(kr, (J, C)) + 1j * jax.random.normal(kr, (J, C))
        aaH = a[:, :, None] * jnp.conj(a)[:, None, :]
        aaH = aaH / jnp.maximum(
            jnp.real(jnp.trace(aaH, axis1=-2, axis2=-1))[:, None, None], _EPS
        )
        R0 = (jnp.eye(C, dtype=jnp.complex64)[None] * 0.8
              + 0.2 * C * aaH.astype(jnp.complex64))
        R0 = jnp.broadcast_to(R0[:, None], (J, F, C, C)).astype(jnp.complex64)
    else:
        R0 = jnp.asarray(R_init, jnp.complex64)
    W, P, A, R, nlls = _em_loop_hmm(
        jnp.asarray(X, jnp.complex64), W0.astype(jnp.float32), P0, A0, R0,
        n_em, not sticky,
    )
    return MultichannelNMF(W, P, R, nlls)

"""Fixed-dictionary NMF as a fused multiplicative-update matmul loop.

Replaces sklearn ``non_negative_factorization(X, H=A, init="custom",
update_H=False, solver='mu', beta_loss='frobenius', tol=1e-4, max_iter=150)``
— the workhorse of the reference's conversion (``04_align_n_nmf.py:194-215``,
SURVEY HOT LOOP #3) — plus the residual compensation and conversion algebra
(``04_align_n_nmf.py:292-299, 336-393``) and the TF-v1 NMF prototype
(``nmf_tool/nmf.py:20-80``).

Semantics: given utterance features X (F, D) and the exemplar dictionary
A (K, D), find activations H ≥ 0 (F, K) with X ≈ H·A, A fixed. sklearn's MU
update (W-side, H fixed) is

    H ← H ⊙ (X·Aᵀ) / (H·(A·Aᵀ))          [Frobenius]
    H ← H ⊙ ((X ⊘ H·A)·Aᵀ) / (1·Aᵀ)      [KL]

Design choices:
- X·Aᵀ is loop-invariant → computed once.
- The denominator is associated as (H·A)·Aᵀ, NOT H·(A·Aᵀ): with K exemplar
  frames ≫ D feature dims this is 2·F·K·D instead of F·K² FLOPs per iteration
  and avoids materializing the K×K Gram (576 MB at K=12k). The elementwise
  multiply/divide fuses into the matmul epilogue.
- Every matmul runs at full float32 precision (``_HIGHEST``).
- Convergence mirrors sklearn: ‖X − H·A‖_F checked every 10 iterations,
  stop when (prev_err − err) < tol·err_init, inside one ``lax.while_loop``
  (no host round-trips).
- The dictionary axis K shards across devices: both per-iteration matmuls
  reduce/broadcast over K with one psum pair (see parallel.sharded_nmf).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_EPS = 2.220446049250313e-16  # np.finfo(float64).eps — sklearn's EPSILON
# Every matmul here asks for full float32 precision: a GPU may otherwise run
# float32 matmuls in TF32, and the solve is held to sklearn's float64 MU.
_HIGHEST = jax.lax.Precision.HIGHEST


class NmfState(NamedTuple):
    H: jnp.ndarray           # (F, K) activations
    n_iter: jnp.ndarray      # iterations actually run
    error: jnp.ndarray       # final Frobenius error ||X - H·A||_F


def _mu_step_frobenius(H, X, A, numerator, l1=0.0):
    # accumulate in f32 regardless of the storage dtype (bf16 option);
    # l1 > 0 adds the standard sparse-coding penalty λ‖H‖₁ to the objective,
    # which in MU form simply adds λ to the denominator (exemplar-based VC
    # conventionally uses sparse activations — Wu et al., the paper the
    # reference implements, penalize H exactly this way)
    denom = jnp.dot(
        jnp.dot(H, A, precision=_HIGHEST,
                preferred_element_type=jnp.float32).astype(H.dtype),
        A.T,
        precision=_HIGHEST, preferred_element_type=jnp.float32,
    ) + l1
    denom = jnp.where(denom == 0.0, _EPS, denom)
    return (H.astype(jnp.float32) * (numerator.astype(jnp.float32) / denom)).astype(H.dtype)


def _mu_step_kl(H, X, A, row_sum_A, l1=0.0):
    WH = jnp.dot(H, A, precision=_HIGHEST,
                 preferred_element_type=jnp.float32).astype(H.dtype)
    ratio = X / jnp.maximum(WH, _EPS)
    num = jnp.dot(ratio, A.T, precision=_HIGHEST,
                  preferred_element_type=jnp.float32).astype(H.dtype)
    denom = row_sum_A + l1
    denom = jnp.where(denom == 0.0, _EPS, denom)
    return H * (num / denom)


@partial(jax.jit, static_argnames=("beta_loss", "max_iter", "check_every", "work_dtype"))
def nmf_activations(
    X: jnp.ndarray,
    A: jnp.ndarray,
    beta_loss: str = "frobenius",
    tol: float = 1e-4,
    max_iter: int = 150,
    check_every: int = 10,
    work_dtype=None,
    l1: float = 0.0,
) -> NmfState:
    """Solve for activations H ≥ 0 with X ≈ H·A, A fixed.

    Defaults reproduce the reference's solver budget
    (``04_align_n_nmf.py:212-213``). Initialization matches sklearn's
    ``update_H=False`` path: H = full(sqrt(mean(X)/K)).

    ``work_dtype=jnp.bfloat16`` stores H/A/Num in bf16 (halves HBM traffic of
    the memory-bound MU matmuls; accumulation stays f32 via
    preferred_element_type). Convergence is within ~1% of the f32 fixed point
    — see tests — but NOT sklearn-parity; keep f32 for parity work.

    ``l1 > 0`` adds the sparse-coding penalty λ‖H‖₁ (λ joins the MU
    denominator) — the standard sparsity constraint of exemplar-based VC
    (the formulation the reference implements conventionally uses sparse
    activations; sklearn exposes the same thing as ``alpha_W``/``l1_ratio``).
    λ=0 is exactly the unpenalized sklearn-parity update.
    """
    F = X.shape[0]
    K = A.shape[0]
    out_dtype = X.dtype
    dtype = work_dtype or X.dtype
    X = X.astype(dtype)
    A = A.astype(dtype)

    avg = jnp.sqrt(jnp.maximum(X.mean(), 0.0) / K)
    H0 = jnp.full((F, K), avg, dtype=dtype)

    if beta_loss == "frobenius":
        # accumulate the loop-invariant numerator in f32 even in bf16 mode
        numerator = jnp.dot(X, A.T, precision=_HIGHEST,
                            preferred_element_type=jnp.float32).astype(dtype)
        step = lambda H: _mu_step_frobenius(H, X, A, numerator, l1=l1)
    elif beta_loss in ("kullback-leibler", "kl"):
        row_sum_A = jnp.sum(A, axis=1)[None, :].astype(dtype)
        step = lambda H: _mu_step_kl(H, X, A, row_sum_A, l1=l1)
    else:
        raise ValueError(f"unknown beta_loss {beta_loss!r}")

    def frob_error(H):
        R = X.astype(jnp.float32) - jnp.dot(
            H, A, precision=_HIGHEST, preferred_element_type=jnp.float32)
        return jnp.sqrt(jnp.sum(R * R))

    def kl_error(H):
        # sklearn's convergence/reported error for beta_loss='kullback-
        # leibler' is sqrt(2·D_KL(X ‖ HA)) (_beta_divergence with
        # square_root=True, WH clipped at float32 eps, zero-X terms dropped)
        # — NOT the Frobenius norm; the tol cadence must match it
        Xf = X.astype(jnp.float32)
        Yh = jnp.maximum(
            jnp.dot(H, A, precision=_HIGHEST,
                    preferred_element_type=jnp.float32), 1.1920929e-07)
        div = (jnp.sum(jnp.where(Xf > 0,
                                 Xf * jnp.log(jnp.maximum(Xf, 1e-30) / Yh),
                                 0.0))
               - jnp.sum(Xf) + jnp.sum(Yh))
        return jnp.sqrt(jnp.maximum(2.0 * div, 0.0))

    error_fn = frob_error if beta_loss == "frobenius" else kl_error

    err_init = error_fn(H0)
    n_blocks = max_iter // check_every

    def cond(carry):
        _, block, prev_err, done = carry
        return (block < n_blocks) & ~done

    def body(carry):
        H, block, prev_err, done = carry
        H = jax.lax.fori_loop(0, check_every, lambda _, h: step(h), H)
        err = error_fn(H)
        converged = (tol > 0) & ((prev_err - err) < tol * err_init)
        return (H, block + 1, err, converged)

    H, blocks, err, _ = jax.lax.while_loop(
        cond, body, (H0, jnp.int32(0), err_init, jnp.bool_(False))
    )
    # remainder iterations when max_iter is not a multiple of check_every
    rem = max_iter - n_blocks * check_every
    n_iter = blocks * check_every
    if rem:
        H = jax.lax.fori_loop(0, rem, lambda _, h: step(h), H)
        err = error_fn(H)
        n_iter = n_iter + rem
    return NmfState(H.astype(out_dtype), n_iter, err)


@partial(jax.jit, static_argnames=("k", "beta_loss", "n_iter"))
def prune_topk_refine(
    X: jnp.ndarray,
    A: jnp.ndarray,
    H: jnp.ndarray,
    k: int,
    beta_loss: str = "frobenius",
    n_iter: int = 100,
) -> NmfState:
    """Adaptive per-frame dictionary pruning: re-solve each frame over only
    its top-k exemplars.

    Exemplar-based VC wants each frame explained by a FEW exemplars; the
    dense MU solve instead spreads activation mass over the whole dictionary
    (the L1 lever tempers but never zeroes it). This refinement imposes hard
    per-frame sparsity: take the global solve's H, keep each frame's k
    largest activations, gather that frame's private (k, D) dictionary, and
    re-run the same MU update batched over frames (einsum batched matvecs).
    The refined activations scatter back into a (F, K) H with ≤k nonzeros
    per row, so every downstream
    consumer (conversion H·B, residual, serving) is unchanged.

    Unlike ``sparsity_l1`` this is supported-set sparsity — the re-solve is
    UNPENALIZED on the kept support, so reconstruction on the support is not
    biased toward zero. Warm-started from the kept values (MU keeps them
    positive). Beyond-reference: the reference's solver has no pruning
    (``04_align_n_nmf.py:194-215`` solves the dense problem only).
    """
    F, D = X.shape
    K = A.shape[0]
    k = min(k, K)
    out_dtype = X.dtype
    vals, idx = jax.lax.top_k(H, k)                    # (F, k)
    Asel = A[idx]                                      # (F, k, D)
    h0 = vals.astype(jnp.float32)
    Xf = X.astype(jnp.float32)
    Af = Asel.astype(jnp.float32)

    if beta_loss == "frobenius":
        num = jnp.einsum("fd,fkd->fk", Xf, Af, precision=_HIGHEST)  # loop-invariant

        def step(h):
            WH = jnp.einsum("fk,fkd->fd", h, Af, precision=_HIGHEST)
            denom = jnp.einsum("fd,fkd->fk", WH, Af, precision=_HIGHEST)
            return h * num / jnp.where(denom == 0.0, _EPS, denom)
    elif beta_loss in ("kullback-leibler", "kl"):
        rs = jnp.sum(Af, axis=2)                       # (F, k)
        rs = jnp.where(rs == 0.0, _EPS, rs)

        def step(h):
            WH = jnp.einsum("fk,fkd->fd", h, Af, precision=_HIGHEST)
            ratio = Xf / jnp.maximum(WH, _EPS)
            return h * jnp.einsum("fd,fkd->fk", ratio, Af, precision=_HIGHEST) / rs
    else:
        raise ValueError(f"unknown beta_loss {beta_loss!r}")

    h = jax.lax.fori_loop(0, n_iter, lambda _, hh: step(hh), h0)
    # report the error in the SAME metric as nmf_activations for this
    # beta_loss (Frobenius norm, or sqrt(2·D_KL) for KL) so NmfState.error
    # stays comparable before/after enabling prune_topk
    Yh = jnp.einsum("fk,fkd->fd", h, Af, precision=_HIGHEST)
    if beta_loss == "frobenius":
        resid = Xf - Yh
        err = jnp.sqrt(jnp.sum(resid * resid))
    else:
        Yh = jnp.maximum(Yh, 1.1920929e-07)
        div = (jnp.sum(jnp.where(Xf > 0,
                                 Xf * jnp.log(jnp.maximum(Xf, 1e-30) / Yh),
                                 0.0))
               - jnp.sum(Xf) + jnp.sum(Yh))
        err = jnp.sqrt(jnp.maximum(2.0 * div, 0.0))
    Hs = jnp.zeros((F, K), out_dtype).at[
        jnp.arange(F)[:, None], idx].set(h.astype(out_dtype))
    return NmfState(Hs, jnp.int32(n_iter), err)


@jax.jit
def sharpen_activations(
    H: jnp.ndarray, A: jnp.ndarray, X: jnp.ndarray, gamma: jnp.ndarray
) -> jnp.ndarray:
    """Activation sharpening: H ← γ-power of H, refit per-frame gain.

    Raising the (non-negative) activations to γ > 1 concentrates each
    frame's mass onto its dominant exemplars — a softer relative of top-k
    pruning. The power destroys the reconstruction scale, so each frame gets
    the least-squares gain s_f = ⟨X_f, X̂_f⟩/‖X̂_f‖² (X̂ = Hᵞ·A) restoring the
    fit before conversion. γ = 1 with the refit is a pure per-frame gain
    re-calibration (s ≈ 1 at the solver fixed point)."""
    Hs = jnp.power(H, gamma)
    Xh = jnp.dot(Hs, A, precision=_HIGHEST, preferred_element_type=jnp.float32)
    s = (X * Xh).sum(axis=1) / jnp.maximum((Xh * Xh).sum(axis=1), _EPS)
    return jnp.maximum(s, 0.0)[:, None].astype(H.dtype) * Hs


@partial(jax.jit, static_argnames=("mode",))
def residual_compensation(
    X: jnp.ndarray, H: jnp.ndarray, A: jnp.ndarray, mode: str = "correct"
) -> jnp.ndarray:
    """Residual factor R (F, D) such that conversion multiplies HᵀB by R.

    mode="correct": R = X / max(H·A, eps) — the multiplicative spectral
    residual (log r = log X − log X̂), which is what residual compensation
    means in the exemplar-VC formulation.

    mode="reference": byte-faithful reproduction of the reference quirk
    (``04_align_n_nmf.py:292-299, 367-373``): it stores r = log(X̂ − X), zeroes
    the NaNs from negative differences, then composes exp(log Y + log r) — so
    the effective multiplicative factor is r itself where r > 0, exactly 0
    where r == 0 (log 0 → −inf → exp → 0), and **NaN where 0 < X̂−X < 1**
    (log of a negative r). The NaNs are part of the reference's actual output
    and are reproduced here; use this mode only for comparing against
    reference artifacts.
    """
    Xhat = jnp.dot(H, A, precision=_HIGHEST, preferred_element_type=X.dtype)
    if mode == "correct":
        return X / jnp.maximum(Xhat, _EPS)
    elif mode == "reference":
        diff = Xhat - X
        r = jnp.where(diff > 0, jnp.log(diff), 0.0)   # log(neg) NaN → 0
        # exp(log(r)): r>0 → r; r==0 → 0; r<0 → NaN (faithfully propagated)
        return jnp.exp(jnp.log(r))
    raise ValueError(f"unknown residual mode {mode!r}")


@jax.jit
def convert_features(
    H: jnp.ndarray, B: jnp.ndarray, R: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Converted features Y = (H·B) ⊙ R (R optional).

    The reference computes exp(log(Hᵀ·B) + log R) (``04_align_n_nmf.py:371-373``)
    which is exactly this product; the STFT path is plain Hᵀ·B (``:390-391``).
    """
    Y = jnp.dot(H, B, precision=_HIGHEST, preferred_element_type=H.dtype)
    if R is not None:
        Y = Y * R
    return Y

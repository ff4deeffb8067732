"""Least-squares activation variants: QR solve and projected-gradient NNLS.

Completes the reference's unfinished QRMF experiment
(``04_align_n_qrmf.py:192-216`` replaces the NMF ``_factorize`` with a
``scipy.linalg.qr`` call but has a syntax error and never ran). Two working
batched variants:

- :func:`qr_activations` — unconstrained least squares X ≈ H·A via the QR
  decomposition of Aᵀ (one QR + two triangular solves; exact minimizer, may
  produce negative activations).
- :func:`nnls_activations` — non-negative least squares by accelerated
  projected gradient (FISTA) with the exact Lipschitz step 1/σ_max(AAᵀ):
  matmul-only inner loop, fixed iteration count, jit/shard friendly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@jax.jit
def qr_activations(X: jnp.ndarray, A: jnp.ndarray) -> jnp.ndarray:
    """Minimize ‖X − H·A‖_F over unconstrained H: H = X·A⁺ via QR of Aᵀ.

    Aᵀ = Q·R (D×K, K≤D assumed reduced) → H = (R⁻¹·Qᵀ·Xᵀ)ᵀ. For K > D the
    system is underdetermined; we then solve the D-rank normal equations via
    QR of A·Aᵀ-free Gram trick on the transposed problem."""
    K, D = A.shape
    if K <= D:
        Q, R = jnp.linalg.qr(A.T)                 # (D,K),(K,K)
        Ht = jax.scipy.linalg.solve_triangular(R, Q.T @ X.T, lower=False)
        return Ht.T
    # underdetermined: minimum-norm solution H = X·Aᵀ·(A·Aᵀ)⁻¹ is O(K²) memory;
    # instead solve in D-space: H = (X·pinv(A)) with pinv(A) = Aᵀ(AAᵀ)⁻¹ — but
    # AAᵀ is K×K. Use A = QR with Q (K,D): A·v decomposition on the row space.
    Q, R = jnp.linalg.qr(A)                       # A = Q·R, Q (K,D), R (D,D)
    # X ≈ H·Q·R  →  with G = H·Q (F,D): G = X·R⁻¹, minimum-norm H = G·Qᵀ
    G = jax.scipy.linalg.solve_triangular(R.T, X.T, lower=True).T
    return G @ Q.T


@partial(jax.jit, static_argnames=("n_iter",))
def nnls_activations(X: jnp.ndarray, A: jnp.ndarray, n_iter: int = 200) -> jnp.ndarray:
    """Non-negative least squares via FISTA: H ≥ 0 minimizing ‖X − H·A‖_F.

    Mirrors the iteration budget of the reference's 'cd' solver variant
    (``04_align_n_nmf_pytorch.py:207-208``, max_iter=200) with a solver that
    is pure matmuls instead of coordinate descent."""
    F, D = X.shape
    K = A.shape[0]
    dtype = X.dtype

    # Lipschitz constant of ∇f(H) = (H·A − X)·Aᵀ is σ_max(A·Aᵀ) = σ_max(AᵀA);
    # power-iterate on the D×D Gram (cheap) instead of the K×K one.
    G = jnp.dot(A.T, A, preferred_element_type=dtype)  # (D, D)

    def power(carry, _):
        v = carry
        v = G @ v
        return v / jnp.maximum(jnp.linalg.norm(v), 1e-30), None

    v0 = jnp.ones((D,), dtype) / jnp.sqrt(D)
    v, _ = jax.lax.scan(power, v0, None, length=30)
    # the Rayleigh quotient after finite power iteration is a LOWER bound on
    # σ_max, so 1/L could exceed the true FISTA step limit when the top
    # singular values cluster (typical for exemplar dictionaries of similar
    # frames); a 5% safety margin keeps the step inside the convergent range
    L = 1.05 * jnp.maximum(v @ (G @ v), 1e-12)

    XAt = jnp.dot(X, A.T, preferred_element_type=dtype)

    def body(carry, _):
        H, Y, t = carry
        grad = jnp.dot(jnp.dot(Y, A, preferred_element_type=dtype), A.T,
                       preferred_element_type=dtype) - XAt
        H_new = jnp.maximum(Y - grad / L, 0.0)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        Y_new = H_new + ((t - 1.0) / t_new) * (H_new - H)
        return (H_new, Y_new, t_new), None

    H0 = jnp.zeros((F, K), dtype)
    (H, _, _), _ = jax.lax.scan(body, (H0, H0, jnp.asarray(1.0, dtype)), None, length=n_iter)
    return H

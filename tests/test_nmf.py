import jax.numpy as jnp
import numpy as np
import pytest
from sklearn.decomposition import non_negative_factorization

from exemplars_vc_tpu.factorize import (
    convert_features,
    nmf_activations,
    nnls_activations,
    qr_activations,
    residual_compensation,
)


def _problem(F=40, K=60, D=25, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = np.abs(rng.standard_normal((K, D))).astype(dtype)
    H_true = np.abs(rng.standard_normal((F, K))).astype(dtype) * (rng.random((F, K)) < 0.1)
    X = (H_true @ A + 0.01 * np.abs(rng.standard_normal((F, D)))).astype(dtype)
    return X, A


def sklearn_fixed_dict(X, A, beta_loss="frobenius", tol=1e-4, max_iter=150):
    """The reference's exact sklearn call (04_align_n_nmf.py:212-213)."""
    W, H, n_iter = non_negative_factorization(
        X=X, H=A, init="custom", update_H=False, n_components=A.shape[0],
        solver="mu", beta_loss=beta_loss, tol=tol, max_iter=max_iter,
    )
    return W, n_iter


def test_matches_sklearn_frobenius():
    X, A = _problem()
    W_ref, n_ref = sklearn_fixed_dict(X, A)
    st = nmf_activations(jnp.asarray(X), jnp.asarray(A))
    H = np.asarray(st.H, dtype=np.float64)
    # same solver semantics → same fixed point within float32 drift
    Xhat_ref = W_ref @ A
    Xhat = H @ A
    np.testing.assert_allclose(Xhat, Xhat_ref, rtol=5e-3, atol=5e-3)
    rel = np.linalg.norm(H - W_ref) / np.linalg.norm(W_ref)
    assert rel < 5e-2


def test_matches_sklearn_kl():
    X, A = _problem(seed=1)
    W_ref, _ = sklearn_fixed_dict(X, A, beta_loss="kullback-leibler")
    st = nmf_activations(jnp.asarray(X), jnp.asarray(A), beta_loss="kullback-leibler")
    H = np.asarray(st.H, dtype=np.float64)
    np.testing.assert_allclose(H @ A, W_ref @ A, rtol=1e-2, atol=1e-2)


def test_kl_tol_cadence_matches_sklearn():
    """The KL convergence check uses sqrt(2·D_KL) like sklearn's
    _beta_divergence — NOT the Frobenius norm — so the solver stops at the
    same 10-iteration block and reports the same n_iter."""
    X, A = _problem(seed=3)
    for tol in (1e-3, 1e-4):
        _, n_ref = sklearn_fixed_dict(X, A, beta_loss="kullback-leibler",
                                      tol=tol, max_iter=200)
        st = nmf_activations(jnp.asarray(X), jnp.asarray(A),
                             beta_loss="kullback-leibler", tol=tol,
                             max_iter=200)
        assert abs(int(st.n_iter) - n_ref) <= 10, (tol, int(st.n_iter), n_ref)


def test_l1_sparsity_sparsifies_activations():
    """λ‖H‖₁ must increase activation sparsity while keeping a usable fit;
    λ=0 must be bit-identical to the unpenalized solver."""
    X, A = _problem()
    base = nmf_activations(jnp.asarray(X), jnp.asarray(A), tol=0, max_iter=80)
    zero = nmf_activations(jnp.asarray(X), jnp.asarray(A), tol=0, max_iter=80, l1=0.0)
    np.testing.assert_array_equal(np.asarray(base.H), np.asarray(zero.H))

    sparse = nmf_activations(jnp.asarray(X), jnp.asarray(A), tol=0, max_iter=80, l1=2.0)
    Hb, Hs = np.asarray(base.H), np.asarray(sparse.H)
    # MU shrinkage is multiplicative (values decay toward 0 rather than hit
    # it) — measure near-zero mass and total activation, both must shrink
    thresh = 1e-3 * float(Hb.max())
    assert float((Hs < thresh).mean()) > float((Hb < thresh).mean()) + 0.02
    assert Hs.sum() < 0.98 * Hb.sum()
    # the sparse fit must still reconstruct (worse than unpenalized, bounded)
    assert float(sparse.error) < 3.0 * float(base.error) + 1e-6
    assert float(jnp.min(sparse.H)) >= 0.0


def test_error_decreases_and_nonneg():
    X, A = _problem(seed=2)
    st1 = nmf_activations(jnp.asarray(X), jnp.asarray(A), max_iter=10, tol=0.0)
    st2 = nmf_activations(jnp.asarray(X), jnp.asarray(A), max_iter=150, tol=0.0)
    assert float(st2.error) <= float(st1.error) + 1e-9
    assert bool((st2.H >= 0).all())


def test_early_stop_runs_fewer_iters():
    X, A = _problem(seed=3)
    st = nmf_activations(jnp.asarray(X), jnp.asarray(A), tol=1e-1, max_iter=150)
    assert int(st.n_iter) < 150


def test_residual_and_convert_roundtrip():
    X, A = _problem(seed=4)
    st = nmf_activations(jnp.asarray(X), jnp.asarray(A))
    R = residual_compensation(jnp.asarray(X), st.H, jnp.asarray(A), mode="correct")
    # converting with B = A and the residual must reproduce X exactly
    Y = convert_features(st.H, jnp.asarray(A), R)
    np.testing.assert_allclose(np.asarray(Y), X, rtol=1e-4, atol=1e-6)


def test_residual_reference_mode_semantics():
    """The compat mode reproduces the reference's exp(log Y + log r) factor
    exactly (04_align_n_nmf.py:292-299,367-373): r where r=log(X̂−X)>0,
    0 where the diff is non-positive, NaN where 0<X̂−X<1."""
    X, A = _problem(seed=5)
    st = nmf_activations(jnp.asarray(X), jnp.asarray(A))
    R = np.asarray(
        residual_compensation(jnp.asarray(X), st.H, jnp.asarray(A), mode="reference")
    )
    diff = np.asarray(st.H) @ A - X
    big = diff > 1.0
    mid = (diff > 0) & (diff < 1.0)
    neg = diff < 0
    np.testing.assert_allclose(R[big], np.log(diff[big]), rtol=1e-4)
    assert np.isnan(R[mid]).all()
    np.testing.assert_array_equal(R[neg], 0.0)


def test_convert_without_residual():
    X, A = _problem(seed=6)
    st = nmf_activations(jnp.asarray(X), jnp.asarray(A))
    B = A * 2.0
    Y = convert_features(st.H, jnp.asarray(B))
    np.testing.assert_allclose(np.asarray(Y), 2.0 * np.asarray(st.H @ A), rtol=1e-5)


def test_qr_activations_exact_when_overdetermined():
    rng = np.random.default_rng(7)
    K, D, F = 10, 25, 13
    A = rng.standard_normal((K, D))
    H_true = rng.standard_normal((F, K))
    X = H_true @ A
    H = np.asarray(qr_activations(jnp.asarray(X), jnp.asarray(A)))
    np.testing.assert_allclose(H @ A, X, atol=1e-4)  # float32 QR
    np.testing.assert_allclose(H, H_true, atol=1e-3)


def test_qr_activations_underdetermined_reconstructs():
    rng = np.random.default_rng(8)
    K, D, F = 40, 12, 9
    A = rng.standard_normal((K, D))
    X = rng.standard_normal((F, D))
    H = np.asarray(qr_activations(jnp.asarray(X), jnp.asarray(A)))
    np.testing.assert_allclose(H @ A, X, atol=1e-4)  # full row-rank-D fit (float32)


def test_nnls_close_to_scipy():
    import scipy.optimize

    rng = np.random.default_rng(9)
    K, D = 12, 20
    A = np.abs(rng.standard_normal((K, D)))
    x = np.abs(rng.standard_normal(D))
    H = np.asarray(nnls_activations(jnp.asarray(x[None, :]), jnp.asarray(A), n_iter=2000))[0]
    h_ref, _ = scipy.optimize.nnls(A.T, x)
    resid = np.linalg.norm(H @ A - x)
    resid_ref = np.linalg.norm(h_ref @ A - x)
    assert resid <= resid_ref * 1.01 + 1e-8
    assert (H >= 0).all()


def test_lane_padding_is_inert():
    """An unaligned feature width (D = 25) solves exactly. Oracle: the plain
    MU recurrence in float64 numpy from the same H0, whose average is over
    the true D."""
    X, A = _problem(F=24, K=48, D=25, seed=4, dtype=np.float32)
    K = A.shape[0]
    H = np.full((X.shape[0], K), np.sqrt(X.mean() / K), dtype=np.float64)
    X64, A64 = X.astype(np.float64), A.astype(np.float64)
    eps = np.finfo(np.float64).eps
    num = X64 @ A64.T
    for _ in range(60):
        den = (H @ A64) @ A64.T
        H = H * num / np.where(den == 0.0, eps, den)
    st = nmf_activations(jnp.asarray(X), jnp.asarray(A), tol=0.0, max_iter=60)
    np.testing.assert_allclose(np.asarray(st.H), H, rtol=1e-3, atol=1e-6)
    err = np.linalg.norm(X64 - H @ A64)
    np.testing.assert_allclose(float(st.error), err, rtol=1e-4)


def test_bf16_work_dtype_close_to_f32():
    import jax.numpy as jnp2

    X, A = _problem(seed=10, dtype=np.float32)
    f32 = nmf_activations(jnp.asarray(X), jnp.asarray(A), tol=0.0, max_iter=100)
    bf16 = nmf_activations(jnp.asarray(X), jnp.asarray(A), tol=0.0, max_iter=100,
                           work_dtype=jnp2.bfloat16)
    assert bf16.H.dtype == jnp.float32  # result restored to the input dtype
    # bf16 storage converges to within ~1% of the f32 fixed point's error
    assert float(bf16.error) < 1.05 * float(f32.error) + 1e-3
    rel = np.linalg.norm(np.asarray(bf16.H) - np.asarray(f32.H)) / np.linalg.norm(np.asarray(f32.H))
    assert rel < 0.08, rel


def test_prune_topk_refine_support_and_fit():
    """Top-k refinement: ≤k nonzeros per row, reconstruction stays in the
    dense solve's ballpark (and per-frame oracle: the refined frame solves
    its OWN small MU problem — check one frame against float64 numpy MU on
    the gathered dictionary, warm-started identically)."""
    from exemplars_vc_tpu.factorize import prune_topk_refine

    X, A = _problem(F=24, K=80, D=25, seed=7, dtype=np.float32)
    dense = nmf_activations(jnp.asarray(X), jnp.asarray(A), tol=0.0, max_iter=120)
    k = 12
    st = prune_topk_refine(jnp.asarray(X), jnp.asarray(A), dense.H, k=k,
                           beta_loss="frobenius", n_iter=80)
    H = np.asarray(st.H)
    assert H.shape == dense.H.shape
    assert (H > 0).sum(axis=1).max() <= k
    # hard sparsity trades some reconstruction fit for generalization; the
    # refined error must stay the same order as the dense solve's
    assert float(st.error) < 1.6 * float(dense.error) + 1e-3

    # float64 oracle for frame 0
    Hd = np.asarray(dense.H, dtype=np.float64)
    idx = np.argsort(Hd[0])[::-1][:k]
    # jax.lax.top_k and argsort may order ties differently; compare by the
    # SUPPORT SET (as a set) and the refined solution on it
    got_support = set(np.nonzero(H[0])[0].tolist())
    assert got_support == set(idx.tolist())
    Asel = A[idx].astype(np.float64)
    h = Hd[0, idx].copy()
    eps = np.finfo(np.float64).eps
    num = X[0].astype(np.float64) @ Asel.T
    for _ in range(80):
        den = (h @ Asel) @ Asel.T
        h = h * num / np.where(den == 0.0, eps, den)
    np.testing.assert_allclose(np.sort(H[0, idx]), np.sort(h), rtol=2e-3, atol=1e-5)


def test_prune_topk_refine_kl_support():
    from exemplars_vc_tpu.factorize import prune_topk_refine

    X, A = _problem(F=16, K=60, D=25, seed=8, dtype=np.float32)
    dense = nmf_activations(jnp.asarray(X), jnp.asarray(A),
                            beta_loss="kullback-leibler", tol=0.0, max_iter=100)
    st = prune_topk_refine(jnp.asarray(X), jnp.asarray(A), dense.H, k=10,
                           beta_loss="kullback-leibler", n_iter=80)
    H = np.asarray(st.H)
    assert (H > 0).sum(axis=1).max() <= 10
    assert np.isfinite(H).all() and (H >= 0).all()
    # k >= K degenerates to a full re-solve — identical support, finite
    st_full = prune_topk_refine(jnp.asarray(X), jnp.asarray(A), dense.H,
                                k=A.shape[0] + 5, beta_loss="kullback-leibler",
                                n_iter=10)
    assert np.isfinite(np.asarray(st_full.H)).all()


def test_prune_topk_refine_error_metric_matches_beta_loss():
    """NmfState.error from prune_topk_refine must use the SAME metric as the
    dense solver for the given beta_loss (Frobenius norm vs sqrt(2·D_KL)),
    so before/after-pruning error comparisons stay meaningful."""
    from exemplars_vc_tpu.factorize import prune_topk_refine

    X, A = _problem(F=16, K=60, D=25, seed=11, dtype=np.float32)
    Xj, Aj = jnp.asarray(X), jnp.asarray(A)

    for beta in ("frobenius", "kullback-leibler"):
        dense = nmf_activations(Xj, Aj, beta_loss=beta, tol=0.0, max_iter=100)
        st = prune_topk_refine(Xj, Aj, dense.H, k=10, beta_loss=beta, n_iter=80)
        H = np.asarray(st.H, np.float64)
        Yh = H @ A
        if beta == "frobenius":
            expect = np.linalg.norm(X - Yh)
        else:
            Yc = np.maximum(Yh, np.float32(1.1920929e-07))
            div = (np.where(X > 0, X * np.log(np.maximum(X, 1e-30) / Yc), 0.0).sum()
                   - X.sum() + Yc.sum())
            expect = np.sqrt(max(2.0 * div, 0.0))
        np.testing.assert_allclose(float(st.error), expect, rtol=2e-3)


def test_sharpen_activations_gain_refit():
    """γ=1: pure gain refit, s≈1 near the fixed point (reconstruction
    unchanged within tolerance); γ>1 keeps reconstruction bounded and
    concentrates mass (entropy of normalized rows drops)."""
    from exemplars_vc_tpu.factorize import sharpen_activations

    X, A = _problem(F=20, K=60, D=25, seed=9, dtype=np.float32)
    Xj, Aj = jnp.asarray(X), jnp.asarray(A)
    dense = nmf_activations(Xj, Aj, tol=0.0, max_iter=200)
    H1 = np.asarray(sharpen_activations(dense.H, Aj, Xj, jnp.float32(1.0)))
    r0 = np.linalg.norm(X - np.asarray(dense.H) @ A)
    r1 = np.linalg.norm(X - H1 @ A)
    assert r1 < 1.02 * r0 + 1e-5

    H2 = np.asarray(sharpen_activations(dense.H, Aj, Xj, jnp.float32(2.0)))
    r2 = np.linalg.norm(X - H2 @ A)
    # γ=2 visibly costs fit on a dense synthetic solve — only require the
    # refit keeps the residual the same order, finite
    assert np.isfinite(r2) and r2 < 6.0 * r0 + 1e-3

    def entropy(M):
        P = M / np.maximum(M.sum(axis=1, keepdims=True), 1e-12)
        return float(-(P * np.log(np.maximum(P, 1e-12))).sum(axis=1).mean())

    assert entropy(H2) < entropy(np.asarray(dense.H))

"""Dictionary cleaning (`data.dict_prune_frac`): mask semantics.

Measured LOO effect is NEUTRAL for MCD (measured on the real held-out pair
round-5: 6.16 vs 6.15 on the sweep folds) — the lever ships as an opt-in
for perceptual experiments, so these tests pin only its mechanics:
ranking by alignment cost, the kept fraction, inertness of zeroed rows.
"""

import numpy as np
import jax.numpy as jnp

from exemplars_vc_tpu.align.exemplar import (
    alignment_keep_mask,
    apply_keep_mask,
    build_exemplar_dicts_padded,
)


def _problem(seed=0, n=2, t=10, d=4, p=16):
    rng = np.random.default_rng(seed)
    fa = rng.standard_normal((n, t, d)).astype(np.float32)
    fb = rng.standard_normal((n, t, d)).astype(np.float32)
    path_i = np.full((n, p), -1, np.int32)
    path_j = np.full((n, p), -1, np.int32)
    for k in range(n):
        ln = 8 + k
        path_i[k, :ln] = np.arange(ln) % t
        path_j[k, :ln] = (np.arange(ln) * 2) % t
    k_true = int((path_i >= 0).sum())
    return fa, fb, path_i, path_j, k_true


def test_keep_mask_fraction_and_ranking():
    fa, fb, pi, pj, k_true = _problem()
    k_pad = 24
    keep = np.asarray(alignment_keep_mask(fa, fb, pi, pj, k_pad=k_pad,
                                          k_true=k_true, prune_frac=0.25))
    # padded rows never kept
    assert not keep[k_true:].any()
    # kept count ≈ (1 − frac)·k_true (ties at the threshold may keep more)
    assert int(keep.sum()) >= int(0.75 * k_true) - 1
    assert int(keep.sum()) <= k_true
    # the kept rows are exactly the lowest-cost ones
    Am, Bm = build_exemplar_dicts_padded(fa, fb, pi, pj, k_pad=k_pad)
    cost = np.sum((np.asarray(Am) - np.asarray(Bm)) ** 2, axis=1)[:k_true]
    kept_max = cost[keep[:k_true]].max()
    dropped_min = cost[~keep[:k_true]].min() if (~keep[:k_true]).any() else np.inf
    assert kept_max <= dropped_min + 1e-6


def test_prune_zero_rows_inert_in_solver():
    from exemplars_vc_tpu.factorize.nmf import nmf_activations

    fa, fb, pi, pj, k_true = _problem(seed=1)
    k_pad = 24
    A, B = build_exemplar_dicts_padded(np.abs(fa), np.abs(fb), pi, pj,
                                       k_pad=k_pad)
    keep = alignment_keep_mask(np.abs(fa), np.abs(fb), pi, pj, k_pad=k_pad,
                               k_true=k_true, prune_frac=0.5)
    Ap = apply_keep_mask(A, keep)
    X = jnp.abs(jnp.asarray(np.random.default_rng(2)
                            .standard_normal((6, A.shape[1])), jnp.float32))
    st = nmf_activations(X, Ap, tol=0.0, max_iter=30)
    H = np.asarray(st.H)
    assert np.isfinite(H).all()
    # activations on pruned rows collapse to ~0
    dropped = ~np.asarray(keep)
    assert np.abs(H[:, dropped]).max() < 1e-6 * max(np.abs(H).max(), 1e-12)


def test_convert_with_prune_finite(tmp_path):
    import os

    from exemplars_vc_tpu.config import load_config
    from exemplars_vc_tpu.io import ArtifactStore
    from exemplars_vc_tpu.pipelines.convert import convert_utterance

    data = "/root/reference/data"
    if not os.path.isdir(os.path.join(data, "SF1")):
        import pytest

        pytest.skip("bundled corpus not present")
    cfg = load_config(overrides=["data.tar=TF1", "misc.nb_file=2",
                                 "data.dict_prune_frac=0.2",
                                 "nmf.max_iter=20"])
    res = convert_utterance(cfg, ArtifactStore(str(tmp_path)), data,
                            os.path.join(data, "SF1", "100001.wav"),
                            nb_file=2, synth_iters=5)
    assert np.isfinite(res.audio).all()

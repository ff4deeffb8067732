"""Corpus-scale source separation: mixtures data-parallel over the mesh.

The vendored pyfasst separates one mixture per process invocation
(``audioModel.py`` — a FASST object wraps a single audio file); at corpus
scale the reference's answer would have been another ``multiprocessing.Pool``
fan-out. Here the whole corpus is one jitted computation: the multichannel
NMF EM (separate.multichannel) vmaps over a padded batch of mixture STFTs,
and the batch axis shards over the mesh's ``data`` axis — every EM step runs
on all mixtures on all chips with NO cross-device communication (mixtures
are independent; the sharding is pure SPMD fan-out, the accelerator analog of
the reference's process pool).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from exemplars_vc_tpu.parallel.mesh import DATA_AXIS, make_mesh, shard_batch
from exemplars_vc_tpu.separate.multichannel import _em_loop, _wiener_images


@partial(jax.jit, static_argnames=("n_em", "n_nmf_inner"))
def _em_batch(X, W0, H0, R0, n_em: int, n_nmf_inner: int):
    """vmapped EM over a batch of mixtures: X (M, F, N, C), params (M, ...)."""
    return jax.vmap(lambda x, w, h, r: _em_loop(x, w, h, r, n_em, n_nmf_inner))(
        X, W0, H0, R0
    )


@jax.jit
def _images_batch(X, W, H, R):
    return jax.vmap(_wiener_images)(X, W, H, R)


def separate_batch(
    X: jnp.ndarray,
    n_sources: int = 2,
    n_components: int = 4,
    n_em: int = 30,
    n_nmf_inner: int = 1,
    key: jax.Array | None = None,
    mesh=None,
):
    """Fit + separate a batch of mixture STFTs, sharded over the data axis.

    X: (M, F, N, C) complex mixture STFTs (pad ragged mixtures to a common
    frame count; padded frames are near-silent and separate harmlessly).
    Returns (images (M, J, F, N, C) complex — still device-resident and
    sharded — and the per-mixture negative-log-likelihood traces (M, n_em)).
    """
    M, F, N, C = X.shape
    if key is None:
        key = jax.random.PRNGKey(0)
    kw, kh, kr = jax.random.split(key, 3)
    J, K = n_sources, n_components
    W0 = jax.random.normal(kw, (M, J, F, K)) ** 2
    H0 = jax.random.normal(kh, (M, J, K, N)) ** 2
    # per-mixture spatial inits through the SAME helper as the
    # single-mixture path (separate.multichannel.random_spatial_init)
    from exemplars_vc_tpu.separate.multichannel import random_spatial_init

    R0 = jax.vmap(lambda k: random_spatial_init(k, J, F, C))(
        jax.random.split(kr, M))

    if mesh is None:
        mesh = make_mesh()
    with mesh:
        Xs = shard_batch(jnp.asarray(X, jnp.complex64), mesh)
        W0 = shard_batch(W0.astype(jnp.float32), mesh)
        H0 = shard_batch(H0.astype(jnp.float32), mesh)
        R0 = shard_batch(R0, mesh)
        model = _em_batch(Xs, W0, H0, R0, n_em, n_nmf_inner)
        images = _images_batch(Xs, model.W, model.H, model.R)
    return images, model.neg_log_like

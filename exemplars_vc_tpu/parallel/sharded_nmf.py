"""Dictionary-sharded NMF: the exemplar dictionary split across devices.

The scaling design BASELINE.json demands (100k+-frame dictionaries across
several devices): the K axis of the exemplar dictionary A (K, D) and of the
activations H (F, K) is sharded over the mesh's ``dict`` axis. Per MU
iteration:

    P   = H_loc · A_loc            → partial (F, D) → **psum across devices**
    Den = P · A_locᵀ               → local (F, K_loc)
    Num = X · A_locᵀ               → local, loop-invariant
    H_loc ← H_loc ⊙ Num / Den      → local

One (F, D)-sized all-reduce per iteration — tiny next to the two K-sized
matmuls — so scaling is compute-bound; X is replicated. Convergence checks
reuse the psum'd P, so every shard sees the same error and the while_loop
stays in lock-step.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from exemplars_vc_tpu.factorize.nmf import _EPS, _HIGHEST, NmfState
from exemplars_vc_tpu.parallel.mesh import DICT_AXIS


@lru_cache(maxsize=32)
def _jitted_solver(mesh: Mesh, axis: str, tol: float, max_iter: int,
                   check_every: int):
    """Build the jitted shard_map solver ONCE per (mesh, solver config).

    A fresh jax.jit wrapper per call would retrace and recompile every
    invocation; caching the callable lets jit's own shape cache work."""

    def solve(X, A, avg):
        # runs per-shard: A is (K_loc, D), H_loc (F, K_loc)
        F = X.shape[0]
        K_loc = A.shape[0]
        H0 = jnp.full((F, K_loc), avg[0], dtype=X.dtype)
        Num = jnp.dot(X, A.T, precision=_HIGHEST,
                      preferred_element_type=X.dtype)

        def recon(H):
            Ploc = jnp.dot(H, A, precision=_HIGHEST,
                           preferred_element_type=X.dtype)
            return jax.lax.psum(Ploc, axis)

        def step(H):
            Pfull = recon(H)
            Den = jnp.dot(Pfull, A.T, precision=_HIGHEST,
                          preferred_element_type=X.dtype)
            Den = jnp.where(Den == 0.0, _EPS, Den)
            return H * (Num / Den)

        def frob_error(H):
            R = X - recon(H)
            return jnp.sqrt(jnp.sum(R * R))

        err_init = frob_error(H0)
        n_blocks = max_iter // check_every

        def cond(c):
            _, blk, _, done = c
            return (blk < n_blocks) & ~done

        def body(c):
            H, blk, prev, done = c
            H = jax.lax.fori_loop(0, check_every, lambda _, h: step(h), H)
            err = frob_error(H)
            conv = (tol > 0) & ((prev - err) < tol * err_init)
            return (H, blk + 1, err, conv)

        H, blocks, err, _ = jax.lax.while_loop(
            cond, body, (H0, jnp.int32(0), err_init, jnp.bool_(False))
        )
        # remainder iterations when max_iter % check_every != 0 — same
        # semantics as the single-device solver (factorize/nmf.py)
        rem = max_iter - n_blocks * check_every
        n_iter = blocks * check_every
        if rem:
            H = jax.lax.fori_loop(0, rem, lambda _, h: step(h), H)
            err = frob_error(H)
            n_iter = n_iter + rem
        return NmfState(H, n_iter, err)

    shard_fn = jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(P(), P(axis, None), P()),
        out_specs=NmfState(P(None, axis), P(), P()),
        check_vma=False,
    )
    return jax.jit(shard_fn)


def sharded_nmf_activations(
    X: jnp.ndarray,
    A: jnp.ndarray,
    mesh: Mesh,
    tol: float = 1e-4,
    max_iter: int = 150,
    check_every: int = 10,
    axis: str = DICT_AXIS,
) -> NmfState:
    """Frobenius-MU activations with A/H sharded on ``axis`` of ``mesh``.

    X: (F, D) replicated; A: (K, D) with K divisible by the axis size.
    Returns H (F, K) sharded over ``axis`` (fetch with jax.device_get if a
    host copy is needed)."""
    K = A.shape[0]
    n_shards = mesh.shape[axis]
    if K % n_shards:
        raise ValueError(f"K={K} not divisible by {n_shards} dictionary shards")

    avg = jnp.sqrt(jnp.maximum(X.mean(), 0.0) / K)

    fn = _jitted_solver(mesh, axis, float(tol), int(max_iter), int(check_every))
    X = jax.device_put(X, NamedSharding(mesh, P()))
    A = jax.device_put(A, NamedSharding(mesh, P(axis, None)))
    avg = jax.device_put(jnp.reshape(avg, (1,)), NamedSharding(mesh, P()))
    return fn(X, A, avg)

"""Dynamic time warping as a batched anti-diagonal wavefront in JAX.

Replaces the reference's pure-Python O(T_a·T_b) DP (the ``dtw`` package,
called per utterance pair under multiprocessing at
``01_make_dict_parallel.py:215-249`` with cost ``sum((x-y)**2)`` — declared
the most expensive step of the whole system, ``README.md:8``).

Accelerator-first design — nothing here resembles the scalar DP loop:

1. The cost matrix is ONE matmul: ‖a‖² + ‖b‖² − 2·a·bᵀ → matmul work, batched
   over utterance pairs.
2. The DP recurrence is sequential only along anti-diagonals, so the matrix is
   *skewed* (row d holds diagonal i+j=d laid out along i) and a single
   ``lax.scan`` sweeps diagonals; each step is pure vector work (shifted mins)
   on a whole wavefront → vector ops, no per-cell control flow.
3. Direction choices are stored as int8 in skewed layout; backtrace is a
   fixed-length ``lax.scan`` over at most T_a+T_b−1 steps.
4. Ragged pairs are padded to bucket sizes and masked with +BIG; ``vmap``
   batches everything. Multi-device: shard the pair axis (see
   exemplars_vc_tpu.parallel).

Semantics match the classic recurrence used by the ``dtw`` package:
D[i,j] = C[i,j] + min(D[i−1,j−1], D[i−1,j], D[i,j−1]), with the traceback
preferring diagonal on ties, and the returned distance normalized by
T_a + T_b (as the reference's dtw() returns).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

# plain python float, NOT jnp.float32(...): a module-level device constant
# would initialize the default backend at import time, racing ahead of any
# CLI platform override
BIG = 1e30


class DtwResult(NamedTuple):
    distance: jnp.ndarray       # normalized distance  D[end]/(len_a+len_b)
    raw_distance: jnp.ndarray   # D[len_a-1, len_b-1]
    path_i: jnp.ndarray         # (max_path,) int32, padded with -1
    path_j: jnp.ndarray         # (max_path,) int32, padded with -1
    path_len: jnp.ndarray       # () int32


def pairwise_sqdist(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(Ta, D), (Tb, D) → (Ta, Tb) squared-euclidean cost via one matmul.

    This is the reference's ``dist=sum((x-y)**2)`` (``01_make_dict_parallel.py:226``)
    recast as matmul work."""
    a2 = jnp.sum(a * a, axis=-1, keepdims=True)
    b2 = jnp.sum(b * b, axis=-1, keepdims=True)
    cross = jnp.dot(a, b.T, precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)
    return jnp.maximum(a2 + b2.T - 2.0 * cross, 0.0)


def _skew(C: jnp.ndarray) -> jnp.ndarray:
    """(Ta, Tb) → (Ta+Tb−1, Ta) with Sk[d, i] = C[i, d−i] (invalid → BIG)."""
    ta, tb = C.shape
    n_diag = ta + tb - 1
    rows = jnp.pad(C, ((0, 0), (0, n_diag - tb)), constant_values=BIG)

    def roll_row(row, shift):
        return jnp.roll(row, shift)

    skewed = jax.vmap(roll_row)(rows, jnp.arange(ta))
    return skewed.T  # (n_diag, Ta)


_DIAG_BLOCK = 128   # wavefront steps per outer-loop iteration


def _dtw_cost_dirs(C: jnp.ndarray, len_a, len_b):
    """Wavefront DP. Returns (final cost D[len_a-1,len_b-1], dirs skewed).

    dirs codes: 0 = diag (i−1, j−1), 1 = up (i−1, j), 2 = left (i, j−1).

    Blocked sweep: an outer ``lax.while_loop`` whose trip bound is TRACED
    (ceil((len_a+len_b−1)/128) blocks) runs 128 statically-unrolled wavefront
    steps per iteration, reading one (128, Ta) slice of the skewed costs and
    writing one (128, Ta) block of direction codes. Why this exact shape:

    - a flat 1800-step ``lax.scan`` compiled slowly (compile time scaled
      with the trip count), and a flat 1800-step ``while_loop`` ran 10×
      slower steady-state (per-iteration loop overhead on tiny vector
      work);
    - the traced bound means XLA cannot unroll the outer loop (the compiled
      program stays ~128 steps of vector ops regardless of utterance
      length), and short pairs in a large padding bucket exit after their
      true diagonal count;
    - 128 unrolled steps amortize the loop overhead that made the flat
      while_loop slow.
    """
    ta, tb = C.shape
    n_diag = ta + tb - 1
    W = _DIAG_BLOCK
    n_blocks_max = (n_diag + W - 1) // W
    i_idx = jnp.arange(ta)

    # mask padded region beyond true lengths
    valid_ij = (i_idx[:, None] < len_a) & (jnp.arange(tb)[None, :] < len_b)
    C = jnp.where(valid_ij, C, BIG)
    sk = _skew(C)  # (n_diag, ta)
    sk = jnp.pad(sk, ((0, n_blocks_max * W - n_diag), (0, 0)),
                 constant_values=BIG)

    def step(d, sk_d, prev, prev2):
        j = d - i_idx                  # column index at wavefront position i
        on_diag = (j >= 0) & (i_idx < ta)

        left = prev                                      # (i, j−1)
        up = jnp.concatenate([jnp.full((1,), BIG), prev[:-1]])     # (i−1, j)
        diag = jnp.concatenate([jnp.full((1,), BIG), prev2[:-1]])  # (i−1, j−1)

        # boundaries: i=0 row may only come from left; j=0 col only from up
        left = jnp.where(j - 1 >= 0, left, BIG)
        up = jnp.where(i_idx - 1 >= 0, up, BIG)
        diag = jnp.where((i_idx - 1 >= 0) & (j - 1 >= 0), diag, BIG)

        stacked = jnp.stack([diag, up, left])            # tie order: diag first
        choice = jnp.argmin(stacked, axis=0).astype(jnp.int8)
        best = jnp.min(stacked, axis=0)
        best = jnp.where((d == 0) & (i_idx == 0), 0.0, best)  # origin cell

        new = jnp.where(on_diag, sk_d + jnp.minimum(best, BIG), BIG)
        new = jnp.minimum(new, BIG)
        return new, choice

    n_valid = len_a + len_b - 1        # traced: true diagonal count
    n_blocks = (n_valid + W - 1) // W

    def cond(state):
        b, _, _, _, _ = state
        return b < n_blocks

    def body(state):
        b, prev, prev2, dirs, final = state
        d0 = b * W
        sk_blk = jax.lax.dynamic_slice_in_dim(sk, d0, W, axis=0)   # (W, Ta)

        def inner(carry, inp):
            prev, prev2, final = carry
            k, sk_d = inp
            new, choice = step(d0 + k, sk_d, prev, prev2)
            final = jnp.where(d0 + k == n_valid - 1, new[len_a - 1], final)
            return (new, prev, final), choice

        (prev, prev2, final), choices = jax.lax.scan(
            inner, (prev, prev2, final), (jnp.arange(W), sk_blk)
        )
        dirs = jax.lax.dynamic_update_slice_in_dim(dirs, choices, d0, axis=0)
        return b + 1, prev, prev2, dirs, final

    dirs0 = jnp.zeros((n_blocks_max * W, ta), dtype=jnp.int8)
    state = (
        jnp.int32(0),
        jnp.full((ta,), BIG),
        jnp.full((ta,), BIG),
        dirs0,
        jnp.float32(BIG),
    )
    _, _, _, dirs, final = jax.lax.while_loop(cond, body, state)
    return final, dirs[:n_diag]


def _backtrace(dirs: jnp.ndarray, len_a, len_b, max_path: int):
    """Follow dirs from (len_a−1, len_b−1) back to (0, 0).

    Emits the path end-to-start; the caller-visible arrays are reversed to
    ascending order and padded with −1."""

    # Blocked walk, same shape as _dtw_cost_dirs' sweep: an outer while_loop
    # with a traced stopping condition (cannot be unrolled; exits at the
    # origin instead of idling through max_path steps) running 128
    # statically-unrolled backtrace steps per iteration, with one
    # batch-uniform block write of the emitted indices.
    W = _DIAG_BLOCK
    n_blocks_max = (max_path + W - 1) // W

    def cond(state):
        b, _, _, done, _, _ = state
        return (~done) & (b < n_blocks_max)

    def body(state):
        b, i, j, done, rev_i, rev_j = state

        def inner(carry, _):
            i, j, done = carry
            out = (jnp.where(done, -1, i), jnp.where(done, -1, j))
            d = i + j
            code = dirs[d, i]
            at_origin = (i == 0) & (j == 0)
            ni = jnp.where(code == 2, i, i - 1)   # left keeps i
            nj = jnp.where(code == 1, j, j - 1)   # up keeps j
            i = jnp.where(at_origin | done, i, ni)
            j = jnp.where(at_origin | done, j, nj)
            return (i, j, done | at_origin), out

        (i, j, done), (outs_i, outs_j) = jax.lax.scan(
            inner, (i, j, done), None, length=W
        )
        rev_i = jax.lax.dynamic_update_slice_in_dim(rev_i, outs_i, b * W, axis=0)
        rev_j = jax.lax.dynamic_update_slice_in_dim(rev_j, outs_j, b * W, axis=0)
        return b + 1, i, j, done, rev_i, rev_j

    state = (
        jnp.int32(0),
        jnp.asarray(len_a - 1, jnp.int32),
        jnp.asarray(len_b - 1, jnp.int32),
        jnp.bool_(False),
        jnp.full((n_blocks_max * W,), -1, jnp.int32),
        jnp.full((n_blocks_max * W,), -1, jnp.int32),
    )
    _, _, _, _, rev_i, rev_j = jax.lax.while_loop(cond, body, state)
    rev_i, rev_j = rev_i[:max_path], rev_j[:max_path]
    path_len = jnp.sum(rev_i >= 0).astype(jnp.int32)
    # reverse the valid prefix into ascending order: position k of the output
    # takes reversed element path_len−1−k
    k = jnp.arange(max_path)
    src = jnp.clip(path_len - 1 - k, 0, max_path - 1)
    path_i = jnp.where(k < path_len, rev_i[src], -1)
    path_j = jnp.where(k < path_len, rev_j[src], -1)
    return path_i, path_j, path_len


def _band_mask(ta: int, tb: int, la, lb, band) -> jnp.ndarray:
    """Sakoe-Chiba band around the stretched diagonal (in source-frame units).

    The banded variant plays the role of the reference's ``fastdtw``
    alternative (``01_make_dict.py:150``): an O(band·T) approximation that is
    exact whenever the optimal path stays within the band."""
    i = jnp.arange(ta, dtype=jnp.float32)[:, None]
    j = jnp.arange(tb, dtype=jnp.float32)[None, :]
    slope = la.astype(jnp.float32) / jnp.maximum(lb.astype(jnp.float32), 1.0)
    return jnp.abs(i - j * slope) <= band


@partial(jax.jit, static_argnames=("band",))
def dtw(
    feat_a: jnp.ndarray,
    feat_b: jnp.ndarray,
    len_a: jnp.ndarray | None = None,
    len_b: jnp.ndarray | None = None,
    band: int | None = None,
) -> DtwResult:
    """Align one utterance pair.

    feat_a: (Ta, D) frames-major features (padded ok when len_a given).
    ``band``: optional Sakoe-Chiba band half-width in frames (None = exact
    full DP). Returns a :class:`DtwResult` with ascending index paths.
    """
    ta, tb = feat_a.shape[0], feat_b.shape[0]
    la = jnp.asarray(ta if len_a is None else len_a, dtype=jnp.int32)
    lb = jnp.asarray(tb if len_b is None else len_b, dtype=jnp.int32)
    C = pairwise_sqdist(feat_a.astype(jnp.float32), feat_b.astype(jnp.float32))
    if band is not None:
        C = jnp.where(_band_mask(ta, tb, la, lb, band), C, BIG)
    raw, dirs = _dtw_cost_dirs(C, la, lb)
    path_i, path_j, path_len = _backtrace(dirs, la, lb, ta + tb - 1)
    return DtwResult(raw / (la + lb).astype(jnp.float32), raw, path_i, path_j, path_len)


@partial(jax.jit, static_argnames=("band",))
def dtw_batch(
    feats_a: jnp.ndarray,
    feats_b: jnp.ndarray,
    lens_a: jnp.ndarray,
    lens_b: jnp.ndarray,
    band: int | None = None,
) -> DtwResult:
    """Batched alignment: (N, Ta, D) vs (N, Tb, D) with true lengths.

    The whole dictionary build that the reference fans out over worker
    processes (``01_make_dict_parallel.py:242-245``) becomes one vmapped,
    jitted call — shard the leading axis over a mesh for multi-device."""
    return jax.vmap(partial(dtw, band=band))(feats_a, feats_b, lens_a, lens_b)

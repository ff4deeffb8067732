"""Sequence-parallel DTW: one long alignment sharded across devices.

The reference cannot align beyond one process's memory/time (full O(Ta·Tb)
python DP per pair). This module scales a SINGLE alignment across a mesh —
the sequence-parallel design SURVEY §5.7 / BASELINE call for:

- rows of the cost matrix are sharded over the mesh axis (device d owns the
  row block [d·R, (d+1)·R));
- columns are processed in blocks of ``col_block``; devices form a systolic
  pipeline over "super-steps": at step s device d works on column block
  s − d, so all devices are busy once the pipeline fills
  (steps = n_devices + n_col_blocks − 1);
- after each tile, the tile's bottom row (the DP wavefront state) is sent to
  the next device with ``lax.ppermute`` — the halo exchange rides the
  device interconnect;
- inside a tile the DP runs on the existing skewed anti-diagonal scan with
  boundary values injected from the halos (top row / left column / corner).

Paths: each device keeps its tiles' int8 direction codes; the caller
assembles them into the (Ta, Tb) grid and backtracks on host (exact, same
codes as align.dtw). Memory for directions is O(Ta·Tb/devices) per device.

``keep_dirs=False`` selects a TRUE distance-only variant: cost tiles are
computed on the fly from the feature blocks inside each super-step, the DP
wavefront (bottom row / right column) is accumulated in the scan carry, and
neither the (R, Tb) cost strip nor any direction codes are ever
materialized — per-device working set is O(R·col_block + (R + Tb)·D),
independent of Ta·Tb. Distances are bit-identical to the path mode (same
tile DP, same halo schedule).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from exemplars_vc_tpu.align.dtw import BIG, pairwise_sqdist
from exemplars_vc_tpu.parallel.mesh import DATA_AXIS

_JIT_CACHE: dict = {}


def _skew(C):
    """(R, Cb) → (n_diag, R) with sk[d, i] = C[i, d-i] (BIG off-diagonal)."""
    R, Cb = C.shape
    n_diag = R + Cb - 1
    rows = jnp.pad(C, ((0, 0), (0, n_diag - Cb)), constant_values=BIG)
    return jax.vmap(jnp.roll)(rows, jnp.arange(R)).T


def _diag_step(prev, prev2, sk_d, d, top, corner, left, is_origin, R, Cb):
    """One anti-diagonal of the tile DP with halo injection.

    prev/prev2: D-values of diagonals d-1 / d-2 (each (R,), indexed by i);
    sk_d: (R,) costs of diagonal d. Returns (new (R,), choice (R,) int8)."""
    i_idx = jnp.arange(R)
    j = d - i_idx

    left_n = jnp.where(j - 1 >= 0, prev, BIG)
    up_n = jnp.concatenate([jnp.full((1,), BIG), prev[:-1]])
    diag_n = jnp.concatenate([jnp.full((1,), BIG), prev2[:-1]])
    up_n = jnp.where(i_idx - 1 >= 0, up_n, BIG)
    diag_n = jnp.where((i_idx - 1 >= 0) & (j - 1 >= 0), diag_n, BIG)

    # inject halos at the tile borders (j == d - i, so the i == 0 cell of
    # diagonal d has j == d, and the j == 0 cell has i == d)
    top_d = top[jnp.clip(d, 0, Cb - 1)]
    top_dm1 = jnp.where(d - 1 >= 0, top[jnp.clip(d - 1, 0, Cb - 1)], corner)
    left_d = left[jnp.clip(d, 0, R - 1)]
    left_dm1 = jnp.where(d - 1 >= 0, left[jnp.clip(d - 1, 0, R - 1)], corner)

    up_n = jnp.where((i_idx == 0) & (d < Cb), top_d, up_n)
    left_n = jnp.where((j == 0) & (d < R), left_d, left_n)
    diag_n = jnp.where((i_idx == 0) & (d < Cb), top_dm1, diag_n)
    diag_n = jnp.where((j == 0) & (d < R) & (i_idx > 0), left_dm1, diag_n)

    stacked = jnp.stack([diag_n, up_n, left_n])
    choice = jnp.argmin(stacked, axis=0).astype(jnp.int8)
    best = jnp.min(stacked, axis=0)
    best = jnp.where(is_origin & (d == 0) & (i_idx == 0), 0.0, best)

    on_diag = (j >= 0) & (j < Cb)
    new = jnp.where(on_diag, sk_d + jnp.minimum(best, BIG), BIG)
    return jnp.minimum(new, BIG), choice


def _tile_dp(C, top, corner, left, is_origin):
    """DP over one (R, Cb) tile with boundary halos.

    C: (R, Cb) costs; top: (Cb,) D-values of the row above the tile;
    corner: scalar D-value above-left; left: (R,) D-values of the column left
    of the tile; is_origin: bool — this tile contains the global (0,0) cell.
    Returns (dirs (R, Cb) int8, bottom_row (Cb,), right_col (R,))."""
    R, Cb = C.shape
    i_idx = jnp.arange(R)
    sk = _skew(C)

    def step(carry, dc):
        prev, prev2 = carry
        sk_d, d = dc
        new, choice = _diag_step(prev, prev2, sk_d, d, top, corner, left,
                                 is_origin, R, Cb)
        return (new, prev), (new, choice)

    init = (jnp.full((R,), BIG), jnp.full((R,), BIG))
    _, (costs, dirs_sk) = jax.lax.scan(step, init, (sk, jnp.arange(R + Cb - 1)))

    # unskew: value[i, j] = costs[i + j, i]
    jj = jnp.arange(Cb)
    d_of = i_idx[:, None] + jj[None, :]
    vals = costs[d_of, i_idx[:, None]]                # (R, Cb)
    dirs = dirs_sk[d_of, i_idx[:, None]]
    return dirs, vals[R - 1, :], vals[:, Cb - 1]


def _tile_dp_distance(C, top, corner, left, is_origin):
    """Distance-only tile DP: no stacked diagonals, no direction codes.

    The bottom row / right column are accumulated in the scan carry with
    O(1) dynamic-index updates per diagonal, so peak live memory per tile is
    O(R + Cb) beyond the (R, Cb) cost tile itself.
    Returns (bottom_row (Cb,), right_col (R,))."""
    R, Cb = C.shape
    sk = _skew(C)

    def step(carry, dc):
        prev, prev2, bottom, right = carry
        sk_d, d = dc
        new, _ = _diag_step(prev, prev2, sk_d, d, top, corner, left,
                            is_origin, R, Cb)
        # cell (R-1, d-(R-1)) lands on the bottom row …
        jb = d - (R - 1)
        bot_upd = jax.lax.dynamic_update_index_in_dim(
            bottom, new[R - 1], jnp.clip(jb, 0, Cb - 1), 0)
        bottom = jnp.where((jb >= 0) & (jb < Cb), bot_upd, bottom)
        # … and cell (d-(Cb-1), Cb-1) on the right column
        ir = d - (Cb - 1)
        right_upd = jax.lax.dynamic_update_index_in_dim(
            right, new[jnp.clip(ir, 0, R - 1)], jnp.clip(ir, 0, R - 1), 0)
        right = jnp.where((ir >= 0) & (ir < R), right_upd, right)
        return (new, prev, bottom, right), None

    init = (jnp.full((R,), BIG), jnp.full((R,), BIG),
            jnp.full((Cb,), BIG), jnp.full((R,), BIG))
    (_, _, bottom, right), _ = jax.lax.scan(
        step, init, (sk, jnp.arange(R + Cb - 1)))
    return bottom, right


def sharded_dtw_long(
    feat_a: np.ndarray,
    feat_b: np.ndarray,
    mesh: Mesh,
    axis: str = DATA_AXIS,
    col_block: int | None = None,
    keep_dirs: bool = True,
):
    """Align ONE (Ta, D) vs (Tb, D) pair with rows sharded over ``axis``.

    Ta must divide by the axis size. Returns (distance, dirs (Ta, Tb) int8 on
    host or None). Use :func:`backtrace_host` for the path.
    ``keep_dirs=False`` runs the distance-only variant (module docstring):
    same DP, no (R, Tb) materialization on device."""
    n_dev = mesh.shape[axis]
    ta, tb = feat_a.shape[0], feat_b.shape[0]
    if ta % n_dev:
        raise ValueError(f"Ta={ta} not divisible by {n_dev} devices")
    R = ta // n_dev
    Cb = col_block or min(tb, 512)
    if tb % Cb:
        pad = Cb - tb % Cb
        feat_b = np.pad(feat_b, ((0, pad), (0, 0)))
    nb = feat_b.shape[0] // Cb
    tb_pad = feat_b.shape[0]

    # one jitted executable per (mesh, shape-statics) — a fresh shard_map
    # + jit per call would recompile every invocation
    key = (mesh, axis, R, Cb, nb, tb, tb_pad, keep_dirs)
    fn = _JIT_CACHE.get(key)
    if fn is None:
        def worker(a_loc, b_all):
            rank = jax.lax.axis_index(axis)
            a_loc = a_loc.astype(jnp.float32)
            b_all = b_all.astype(jnp.float32)
            col_ok = jnp.arange(tb_pad) < tb
            if keep_dirs:
                C_loc = pairwise_sqdist(a_loc, b_all)
                C_loc = jnp.where(col_ok[None, :], C_loc, BIG)

            n_steps = n_dev + nb - 1

            def superstep(carry, s):
                top_buf, corner_buf, left_col, prev_bottom_last = carry
                b_idx = s - rank
                active = (b_idx >= 0) & (b_idx < nb)
                bsafe = jnp.clip(b_idx, 0, nb - 1)
                if keep_dirs:
                    C_tile = jax.lax.dynamic_slice(C_loc, (0, bsafe * Cb), (R, Cb))
                else:
                    # distance-only: build the tile from the feature block —
                    # no (R, tb_pad) cost matrix ever lives on device
                    b_blk = jax.lax.dynamic_slice(
                        b_all, (bsafe * Cb, 0), (Cb, b_all.shape[1]))
                    ok = jax.lax.dynamic_slice(col_ok, (bsafe * Cb,), (Cb,))
                    C_tile = jnp.where(ok[None, :],
                                       pairwise_sqdist(a_loc, b_blk), BIG)

                top = jnp.where(rank == 0, jnp.full((Cb,), BIG), top_buf)
                corner = jnp.where(rank == 0, BIG, corner_buf)
                left = jnp.where(b_idx == 0, jnp.full((R,), BIG), left_col)
                is_origin = (rank == 0) & (b_idx == 0)

                if keep_dirs:
                    dirs, bottom, right = _tile_dp(C_tile, top, corner, left,
                                                   is_origin)
                else:
                    bottom, right = _tile_dp_distance(C_tile, top, corner,
                                                      left, is_origin)

                # pass my bottom row (and its left-neighbor corner value) to the
                # next device; it becomes their top halo for column block b_idx
                nxt_top = jax.lax.ppermute(
                    bottom, axis, [(i, (i + 1) % n_dev) for i in range(n_dev)]
                )
                nxt_corner = jax.lax.ppermute(
                    # corner for their NEXT block = last value of this top halo…
                    # but their corner for block b_idx is the bottom-left-1 value =
                    # my previous block's bottom last element
                    prev_bottom_last, axis,
                    [(i, (i + 1) % n_dev) for i in range(n_dev)],
                )
                new_left = jnp.where(active, right, left_col)
                new_prev_last = jnp.where(active, bottom[Cb - 1], prev_bottom_last)

                final = jnp.where(
                    active & (rank == n_dev - 1) & (b_idx == nb - 1),
                    bottom[tb - 1 - (nb - 1) * Cb],
                    0.0,
                )
                out = (dirs, bsafe, active, final) if keep_dirs else final
                return (nxt_top, nxt_corner, new_left, new_prev_last), out

            init = (
                jnp.full((Cb,), BIG), jnp.asarray(BIG, jnp.float32),
                jnp.full((R,), BIG), jnp.asarray(BIG, jnp.float32),
            )
            _, outs = jax.lax.scan(superstep, init, jnp.arange(n_steps))
            if not keep_dirs:
                return jax.lax.psum(jnp.sum(outs), axis)

            all_dirs, blk_ids, actives, finals = outs
            distance = jax.lax.psum(jnp.sum(finals), axis)

            # scatter active tiles into this device's (R, tb_pad) direction strip
            strip = jnp.zeros((R, tb_pad), jnp.int8)

            def place(strip, t):
                d, b, ok = t
                updated = jax.lax.dynamic_update_slice(strip, d, (0, b * Cb))
                return jnp.where(ok, updated, strip), None

            strip, _ = jax.lax.scan(place, strip, (all_dirs, blk_ids, actives))
            return distance, strip

        shard_fn = jax.shard_map(
            worker, mesh=mesh,
            in_specs=(P(axis, None), P()),
            out_specs=(P(), P(axis, None)) if keep_dirs else P(),
            check_vma=False,
        )
        fn = jax.jit(shard_fn)
        _JIT_CACHE[key] = fn
    a = jax.device_put(np.asarray(feat_a), NamedSharding(mesh, P(axis, None)))
    b = jax.device_put(np.asarray(feat_b), NamedSharding(mesh, P()))
    if keep_dirs:
        distance, dirs = fn(a, b)
        return float(distance), np.asarray(dirs)[:, :tb]
    return float(fn(a, b)), None


def backtrace_host(dirs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Follow direction codes (0=diag, 1=up, 2=left) from the end to (0,0)."""
    i, j = dirs.shape[0] - 1, dirs.shape[1] - 1
    pi, pj = [i], [j]
    while i > 0 or j > 0:
        c = dirs[i, j]
        if c == 0:
            i, j = i - 1, j - 1
        elif c == 1:
            i -= 1
        else:
            j -= 1
        pi.append(i)
        pj.append(j)
    return np.asarray(pi[::-1]), np.asarray(pj[::-1])

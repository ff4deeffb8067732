"""Utterance-batch data-parallel DTW over a device mesh.

The dictionary build's pair axis (what the reference fans out over worker
processes, ``01_make_dict_parallel.py:242-245``) shards over the mesh ``data``
axis; each device runs the wavefront kernel on its pairs with zero
communication (embarrassingly parallel, like the reference — but chips, not
processes)."""

from __future__ import annotations

from functools import lru_cache

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from exemplars_vc_tpu.align.dtw import DtwResult, dtw_batch
from exemplars_vc_tpu.parallel.mesh import DATA_AXIS


@lru_cache(maxsize=16)
def _jitted_batch(mesh: Mesh, axis: str):
    """One jitted executable per (mesh, axis) — a fresh jax.jit wrapper per
    call would recompile every invocation."""
    sharding = NamedSharding(mesh, P(axis))
    out_sharding = DtwResult(*(sharding for _ in range(5)))
    return jax.jit(dtw_batch, out_shardings=out_sharding)


def sharded_dtw_batch(
    feats_a, feats_b, lens_a, lens_b, mesh: Mesh, axis: str = DATA_AXIS
) -> DtwResult:
    """dtw_batch with the pair axis sharded over ``axis``. Pair count must be
    divisible by the axis size (pad with dummy pairs if needed)."""
    n = feats_a.shape[0]
    if n % mesh.shape[axis]:
        raise ValueError(f"{n} pairs not divisible by {mesh.shape[axis]} shards")
    args = [
        jax.device_put(a, NamedSharding(mesh, P(axis, *([None] * (a.ndim - 1)))))
        for a in (feats_a, feats_b, lens_a, lens_b)
    ]
    return _jitted_batch(mesh, axis)(*args)

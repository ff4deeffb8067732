"""Device meshes and sharding helpers.

The reference's only parallelism is single-host ``multiprocessing.Pool``
fan-out (``utils.py:183-198``; SURVEY §2.4) — there is nothing to port. This
module defines the framework's two parallel axes from scratch:

- ``data``: utterance-batch data parallelism (DTW pairs, feature extraction,
  warping-net training batches);
- ``dict``: the exemplar dictionary axis — NMF's K dimension sharded across
  devices, with one activation all-reduce per iteration (see sharded_nmf).

Axes live on one :class:`jax.sharding.Mesh`; multi-host pods get their
process groups from :mod:`exemplars_vc_tpu.parallel.distributed` over DCN.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
DICT_AXIS = "dict"


def make_mesh(
    data: int | None = None,
    dict_: int | None = None,
    devices: list | None = None,
) -> Mesh:
    """Build a (data × dict) mesh. Defaults: all devices on ``data``."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if data is None and dict_ is None:
        data, dict_ = n, 1
    elif data is None:
        data = n // dict_
    elif dict_ is None:
        dict_ = n // data
    if data < 1 or dict_ < 1:
        raise ValueError(
            f"mesh {data}x{dict_} has a zero-sized axis "
            f"(an axis larger than the {n} available devices floor-divides "
            f"the other axis to 0)")
    if data * dict_ > n:
        raise ValueError(f"mesh {data}x{dict_} > {n} devices")
    # non-divisible configs intentionally use the first data·dict_ devices
    arr = np.asarray(devices[: data * dict_]).reshape(data, dict_)
    return Mesh(arr, (DATA_AXIS, DICT_AXIS))


def shard_batch(x, mesh: Mesh, axis: str = DATA_AXIS):
    """Place an array with its leading dimension sharded over ``axis``."""
    spec = P(axis, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def replicate(x, mesh: Mesh):
    return jax.device_put(x, NamedSharding(mesh, P()))

"""Multi-host initialization over DCN.

The reference's 'cluster tooling' is two scp scripts (``push_to_server.sh:1``).
Real replacement: ``jax.distributed.initialize`` forms the process group
across hosts (DCN); the global device list then feeds one Mesh spanning all
hosts, and every collective in sharded_nmf/sharded_dtw rides the device
interconnect within a host and the network across hosts."""

from __future__ import annotations

import os

import jax


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> dict:
    """Idempotent jax.distributed bootstrap. Arguments default to the standard
    env vars (JAX_COORDINATOR_ADDRESS etc.) or cluster auto-detection.

    Returns a summary dict {process_index, process_count, local_devices,
    global_devices}.

    NOTE: the idempotency probe must NOT touch jax.process_count() (or any
    other device API) before initialize() — doing so initializes the XLA
    backend and jax.distributed.initialize then raises unconditionally. The
    probe reads jax.distributed's own client state instead, and an
    'already initialized' RuntimeError is treated as success."""
    if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        try:
            # private-API probe — if a JAX upgrade moves it, fall through to
            # initialize() and rely on the 'already initialized' handling
            already = getattr(
                jax._src.distributed.global_state, "client", None) is not None
        except Exception:
            already = False
        if not already:
            try:
                jax.distributed.initialize(
                    coordinator_address=coordinator_address,
                    num_processes=num_processes,
                    process_id=process_id,
                )
            except RuntimeError as e:   # raced/duplicate bootstrap
                if "already" not in str(e).lower():
                    raise
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }

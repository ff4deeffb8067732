#!/usr/bin/env python
"""Scaling harness: large sharded-dictionary NMF conversion (BASELINE config 5).

Measures the dictionary-sharded NMF (exemplars_vc_tpu.parallel.sharded_nmf) on
a synthetic 100k+-frame exemplar dictionary:

- single-device throughput at production scale (K=100k, D=201, F=704 — the
  (F,K)·(K,D) MU matmuls at ~2·2·F·K·D ≈ 57 GFLOP/iter),
- multi-device runs over every mesh size the GPUs of this host allow, with
  the activations checked equal across shard counts.

The run needs GPUs and records the devices it ran on.

Usage:
    python bench_scaling.py [--devices N] [--k 100352] [--iters 50]

Prints one JSON line with per-mesh timings and efficiency.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=100352)  # 100k+, multiple of 1024
    ap.add_argument("--f", type=int, default=704)
    ap.add_argument("--d", type=int, default=201)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--out", type=str, default=None,
                    help="also write the JSON artifact to this path")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from exemplars_vc_tpu.parallel import make_mesh, sharded_nmf_activations
    from exemplars_vc_tpu.runtime import device_record, require_gpu

    require_gpu()
    device = device_record()
    n_dev = args.devices or len(jax.devices())
    log(f"device={device} devices={n_dev} K={args.k} F={args.f} D={args.d}")

    rng = np.random.default_rng(0)
    X = jnp.asarray(np.abs(rng.standard_normal((args.f, args.d))), jnp.float32)
    A = jnp.asarray(np.abs(rng.standard_normal((args.k, args.d))), jnp.float32)
    flops_per_iter = 4.0 * args.f * args.k * args.d  # two (F,K)x(K,D)-class matmuls

    results = []
    H_by_shards = {}
    shard_counts = [s for s in (1, 2, 4, 8, 16, 32) if s <= n_dev and args.k % s == 0]
    for shards in shard_counts:
        mesh = make_mesh(data=1, dict_=shards, devices=jax.devices()[:shards])
        t0 = time.time()
        st = sharded_nmf_activations(X, A, mesh, tol=0.0, max_iter=args.iters)
        jax.block_until_ready(st.H)
        cold = time.time() - t0
        t0 = time.time()
        st = sharded_nmf_activations(X, A, mesh, tol=0.0, max_iter=args.iters)
        jax.block_until_ready(st.H)
        hot = time.time() - t0
        tflops = flops_per_iter * args.iters / hot / 1e12
        H_by_shards[shards] = np.asarray(st.H)
        results.append({
            "dict_shards": shards, "steady_s": round(hot, 3),
            "cold_s": round(cold, 3), "tflops": round(tflops, 2),
            "error": float(st.error),
        })
        log(f"shards={shards}: {hot:.3f}s steady ({tflops:.2f} TFLOP/s)")

    base = results[0]["steady_s"]
    H1 = H_by_shards[shard_counts[0]]
    h_scale = max(float(np.abs(H1).max()), 1e-30)
    for r in results:
        r["speedup"] = round(base / r["steady_s"], 3)
        r["efficiency"] = round(base / r["steady_s"] / r["dict_shards"], 3)
        # correctness: activations must be identical across shard counts
        # (one (F,D) psum per MU iteration is the only collective)
        diff = float(np.abs(H_by_shards[r["dict_shards"]] - H1).max())
        r["h_max_rel_diff_vs_1shard"] = diff / h_scale

    payload = {
        "metric": "sharded-dictionary NMF (K=%d) MU iterations" % args.k,
        "device": device,
        "results": results,
    }
    out = json.dumps(payload)
    print(out, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(out + "\n")


if __name__ == "__main__":
    main()

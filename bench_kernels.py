#!/usr/bin/env python
"""Per-kernel microbenchmarks + roofline accounting on the current backend.

Times each hot kernel with realistic shapes, forcing device completion via a
scalar reduction so the timing does not include a full-array device→host
copy. Each timing uses fresh inputs.

Roofline: the device's achievable peaks are MEASURED, not quoted — a long
matmul chain calibrates matmul FLOP/s (f32 and bf16) and a long elementwise
chain calibrates HBM stream bandwidth. Each modeled kernel then reports
achieved FLOP/s and bytes/s against ``min(peak_flops, AI × bw)`` — the
roofline limit at its arithmetic intensity — and is classified compute- or
HBM-bound. The run needs a GPU and records the device it ran on.

Usage: python bench_kernels.py [--roofline-only]
Prints one JSON line: {device, kernels: {...}, roofline: {...}}.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def log(m):
    print(m, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Roofline calibration: measured peaks, not datasheet numbers
# ---------------------------------------------------------------------------

def _timed_call(fn, *args, n=3):
    """Median wall time of fn(*args) with device materialization.

    Materializes by VALUE (float(...)), which waits for the whole chain."""
    float(fn(*args))  # compile + settle
    times = []
    for i in range(n):
        t0 = time.time()
        float(fn(*args, salt=i + 1))
        times.append(time.time() - t0)
    return float(np.median(times))


def measure_peak_matmul(dtype_name: str, n: int, chain: int) -> float:
    """Achievable matmul FLOP/s: a data-dependent chain of (n,n)@(n,n)
    matmuls generated on device (fresh per run via the salt). FLOPs =
    chain · 2n³."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]

    @partial(jax.jit, static_argnames=("n", "chain"))
    def run(key, salt, n, chain):
        k1, k2 = jax.random.split(jax.random.fold_in(key, salt))
        a = jax.random.normal(k1, (n, n), dtype)
        # pre-scale b once so the chain stays bounded (spectral radius ≲ 2);
        # the body must be a BARE dot — an epilogue astype/scale pass costs
        # as much HBM traffic as the matmul itself at these sizes and halves
        # the measured "peak"
        b = jax.random.normal(k2, (n, n), dtype) * (1.0 / np.sqrt(n))

        def body(_, c):
            return jnp.dot(c, b, preferred_element_type=dtype)

        return jnp.sum(jax.lax.fori_loop(0, chain, body, a)
                       .astype(jnp.float32))

    key = jax.random.PRNGKey(0)
    t = _timed_call(lambda k, salt=0: run(k, salt, n, chain), key)
    flops = chain * 2.0 * n ** 3
    log(f"peak matmul {dtype_name} (n={n}, chain={chain}): "
        f"{flops / t / 1e12:.1f} TFLOP/s")
    return flops / t


def measure_hbm_bandwidth(size: int, chain: int) -> float:
    """Achievable HBM stream bandwidth: a chain of dependent elementwise
    passes over a `size`-float f32 vector; each pass reads + writes the
    vector once → bytes = chain · 2 · 4 · size."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    @partial(jax.jit, static_argnames=("size", "chain"))
    def run(key, salt, size, chain):
        x = jax.random.normal(jax.random.fold_in(key, salt), (size,),
                              jnp.float32)

        def body(i, y):
            # data-dependent scale stops XLA from collapsing the chain
            return y * (1.0 + 1e-7 * (i + 1).astype(jnp.float32))

        return jnp.sum(jax.lax.fori_loop(0, chain, body, x))

    key = jax.random.PRNGKey(1)
    t = _timed_call(lambda k, salt=0: run(k, salt, size, chain), key)
    gbytes = chain * 2.0 * 4.0 * size
    log(f"HBM stream (size={size}, chain={chain}): {gbytes / t / 1e9:.0f} GB/s")
    return gbytes / t


def measure_hbm_matmul_stream_bandwidth(size: int, chain: int) -> float:
    """Achievable HBM bandwidth for matmul-pipelined streaming: a dependent
    chain of skinny matmuls (32, K)·(K, 256) over a `size`-float operand
    (K = size/256) → bytes ≈ chain · 4 · size · 9/8, AI ≈ 14 flop/byte
    (memory-bound: the roofline limit at AI 14 is well under the measured
    matmul peak).

    This matches the traffic profile of the MU kernels, which stream the
    big dictionary A through the matmul units and write only the much
    smaller H; elementwise probes can undershoot what those kernels sustain.
    The scalar chaining (each pass's left operand is scaled by the previous
    pass's mean) keeps passes sequential and un-hoistable."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    K = size // 256

    @partial(jax.jit, static_argnames=("K", "chain"))
    def run(key, salt, K, chain):
        x = jax.random.normal(jax.random.fold_in(key, salt), (K, 256),
                              jnp.float32)
        v0 = jnp.ones((32, K), jnp.float32)

        def body(i, s):
            out = jnp.dot(v0 * (1.0 + 1e-12 * s), x,
                          preferred_element_type=jnp.float32)
            return jnp.mean(out)

        return jax.lax.fori_loop(0, chain, body, jnp.float32(0.0))

    key = jax.random.PRNGKey(2)
    t = _timed_call(lambda k, salt=0: run(k, salt, K, chain), key)
    gbytes = chain * 4.0 * (K * 256 + 32 * K)
    log(f"HBM matmul stream (size={size}, chain={chain}): {gbytes / t / 1e9:.0f} GB/s")
    return gbytes / t


def kernel_models() -> dict:
    """Analytic FLOP/byte models for the NMF MU kernels (f32 storage).

    X (F,D̂), A (K,D̂), H (F,K), D̂ the solver's padded feature width
    (factorize/nmf.py): per iteration two matmuls (H·A then ·Aᵀ) = 4·F·K·D̂
    FLOPs; error evals (init + every 10 iters) are one H·A each. HBM bytes
    per iteration: A streamed twice (2·K·D̂·4) + H-sized traffic ≈ read H
    (mm1) + epilogue read H/num + write H (4·F·K·4); error evals re-stream
    H and A once each. The FFT-based kernels (STFT, Griffin-Lim, WORLD) are
    timed without a model.
    """
    F, Dp = 704, 256
    models = {}
    for K in (7424, 100352):
        it, errs = 50, 6
        flops = (it * 4 + errs * 2) * F * K * Dp + 2 * F * K * Dp  # + numerator
        bts = (it * (2 * K * Dp * 4 + 4 * F * K * 4)
               + errs * (F * K * 4 + K * Dp * 4)
               + (F * K * 4 + K * Dp * 4))
        models[f"nmf_mu_xla_K{K}_50it"] = {"flops": flops, "bytes": bts}
    return models


def build_roofline(results: dict, peak_f32: float, peak_bf16: float,
                   hbm_bw: float, hbm_bw_rw: float | None = None) -> dict:
    """Per-kernel achieved vs roofline-limit accounting.

    ``hbm_bw`` is the calibration bandwidth used for the limits — the best
    of the read-only and read+write stream probes (the MU kernels' traffic
    is read-dominated); ``hbm_bw_rw`` records the balanced probe for
    reference."""
    out = {
        "calibration": {
            "peak_matmul_f32_tflops": round(peak_f32 / 1e12, 2),
            "peak_matmul_bf16_tflops": round(peak_bf16 / 1e12, 2),
            "hbm_stream_gbps": round(hbm_bw / 1e9, 1),
            "ridge_flop_per_byte_f32": round(peak_f32 / hbm_bw, 1),
        },
        "kernels": {},
    }
    if hbm_bw_rw is not None:
        out["calibration"]["hbm_stream_rw_gbps"] = round(hbm_bw_rw / 1e9, 1)
    for name, model in kernel_models().items():
        if name not in results:
            continue
        t = results[name]["median_s"]
        ai = model["flops"] / model["bytes"]
        limit = min(peak_f32, ai * hbm_bw)
        achieved = model["flops"] / t
        out["kernels"][name] = {
            "median_s": t,
            "model_gflops": round(model["flops"] / 1e9, 1),
            "model_gbytes": round(model["bytes"] / 1e9, 3),
            "arith_intensity_flop_per_byte": round(ai, 1),
            "achieved_tflops": round(achieved / 1e12, 3),
            "achieved_gbps": round(model["bytes"] / t / 1e9, 1),
            "bound": "compute" if ai * hbm_bw > peak_f32 else "hbm",
            "roofline_limit_tflops": round(limit / 1e12, 2),
            "pct_of_roofline": round(100.0 * achieved / limit, 1),
            "pct_of_matmul_peak_f32": round(100.0 * achieved / peak_f32, 1),
        }
    # Every hand-written stream probe (elementwise scale chain, reduce
    # chain, skinny-matmul chain) sustains LESS bandwidth than the best
    # MU kernel itself implies — the probes are lower bounds, and the
    # fastest kernel defines the chip's MEASURED bandwidth frontier. Add a
    # frontier-based view so kernels never read as ">100% of roofline":
    # pct_of_frontier_roofline measures each kernel against the limit
    # implied by the best bandwidth any kernel in this table has sustained.
    frontier = max([hbm_bw] + [v["achieved_gbps"] * 1e9
                               for v in out["kernels"].values()
                               if "achieved_gbps" in v])
    out["calibration"]["hbm_frontier_gbps"] = round(frontier / 1e9, 1)
    for name, v in out["kernels"].items():
        if "achieved_tflops" not in v:
            continue
        ai = v["arith_intensity_flop_per_byte"]
        limit2 = min(peak_f32, ai * frontier)
        v["pct_of_frontier_roofline"] = round(
            100.0 * v["achieved_tflops"] * 1e12 / limit2, 1)
    # DTW is wavefront-sequential (scan over anti-diagonals), not a
    # throughput kernel: report DP-cell rate instead of a FLOP roofline
    for name, cells in (("dtw_batch_8x896", 8 * 896 * 896),):
        if name in results:
            t = results[name]["median_s"]
            out["kernels"][name] = {
                "median_s": t,
                "dp_cells": cells,
                "cells_per_s": round(cells / t / 1e6, 1),
                "bound": "latency (sequential anti-diagonal wavefront; "
                         "2·T−1 dependent scan steps)",
            }
    return out


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--roofline-only", action="store_true",
                    help="only calibrate peaks + time the modeled kernels")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from exemplars_vc_tpu.align.dtw import dtw_batch
    from exemplars_vc_tpu.dsp import griffin_lim, mcep, mfcc, stft
    from exemplars_vc_tpu.factorize.nmf import nmf_activations
    from exemplars_vc_tpu.runtime import (
        device_record,
        enable_persistent_compilation_cache,
        require_gpu,
    )
    from exemplars_vc_tpu.world import analyze, synthesize

    require_gpu()
    enable_persistent_compilation_cache()
    rng = np.random.default_rng(0)
    device = device_record()
    log(f"device: {device}")

    def timed(name, make_args, fn, reduce_fn, n=3):
        fn(*make_args())  # compile
        jax.block_until_ready(reduce_fn(fn(*make_args())))
        times = []
        for _ in range(n):
            args = make_args()
            t0 = time.time()
            out = fn(*args)
            float(jnp.sum(reduce_fn(out)))
            times.append(time.time() - t0)
        med = float(np.median(times))
        log(f"{name}: {med:.4f}s  (runs {['%.3f' % t for t in times]})")
        return {"median_s": round(med, 4), "runs": [round(t, 4) for t in times]}

    results = {}

    # batched DTW: 8 pairs, ~900 frames, 20 dims (the dict-build workload)
    T = 896
    results["dtw_batch_8x896"] = timed(
        "dtw_batch_8x896",
        lambda: (
            jnp.asarray(rng.standard_normal((8, T, 20)), jnp.float32),
            jnp.asarray(rng.standard_normal((8, T, 20)), jnp.float32),
            jnp.asarray(rng.integers(700, T, 8), jnp.int32),
            jnp.asarray(rng.integers(700, T, 8), jnp.int32),
        ),
        dtw_batch,
        lambda r: r.raw_distance,
    )

    # NMF MU, production dictionary (K≈7.4k) and 100k scale
    for K in (7424, 100352):
        X = lambda: jnp.asarray(np.abs(rng.standard_normal((704, 201))), jnp.float32)
        A = jnp.asarray(np.abs(rng.standard_normal((K, 201))), jnp.float32)
        results[f"nmf_mu_xla_K{K}_50it"] = timed(
            f"nmf_mu_xla_K{K}_50it",
            lambda: (X(), A),
            lambda x, a: nmf_activations(x, a, tol=0.0, max_iter=50),
            lambda st: st.H,
        )

    # Griffin-Lim 300 on a full-utterance magnitude
    results["griffin_lim_300"] = timed(
        "griffin_lim_300",
        lambda: (jnp.asarray(np.abs(rng.standard_normal((704, 201))), jnp.float32),),
        lambda m: griffin_lim(m, n_iter=300, length=56320),
        lambda y: y,
    )

    # STFT + MFCC + mcep over one utterance batch
    sig = lambda: jnp.asarray(rng.standard_normal(90112), jnp.float32)
    results["stft_1utt"] = timed(
        "stft_1utt", lambda: (sig(),), lambda x: jnp.abs(stft(x)), lambda m: m
    )
    # WORLD analysis, 2 s of audio
    wsig = lambda: jnp.asarray(rng.standard_normal(32000) * 0.1, jnp.float32)
    results["world_analyze_2s"] = timed(
        "world_analyze_2s", lambda: (wsig(),), lambda x: analyze(x),
        lambda f: f.sp,
    )
    if not args.roofline_only:
        results["mfcc_1utt"] = timed(
            "mfcc_1utt", lambda: (sig(),), lambda x: mfcc(x), lambda m: m
        )
        results["mcep_1utt"] = timed(
            "mcep_1utt", lambda: (sig(),), lambda x: mcep(x), lambda c: c
        )

        feats = analyze(wsig())
        results["world_synth_2s"] = timed(
            "world_synth_2s",
            lambda: (feats.f0 + jnp.asarray(rng.random(), jnp.float32) * 0,
                     feats.sp, feats.ap),
            lambda f0, sp, ap: synthesize(f0, sp, ap),
            lambda y: y,
        )

    # ---- roofline: measured peaks + achieved-vs-limit per modeled kernel --
    peak_f32 = measure_peak_matmul("float32", n=4096, chain=16)
    peak_bf16 = measure_peak_matmul("bfloat16", n=4096, chain=16)
    hbm_bw_rw = measure_hbm_bandwidth(size=2 ** 27, chain=16)
    hbm_bw_mm = measure_hbm_matmul_stream_bandwidth(size=2 ** 27, chain=16)
    roofline = build_roofline(results, peak_f32, peak_bf16,
                              max(hbm_bw_rw, hbm_bw_mm), hbm_bw_rw=hbm_bw_rw)
    for k, v in roofline["kernels"].items():
        log(f"roofline {k}: {v}")

    payload = json.dumps({"device": device, "kernels": results,
                          "roofline": roofline})
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
    print(payload, flush=True)


if __name__ == "__main__":
    main()

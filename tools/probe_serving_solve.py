#!/usr/bin/env python
"""Isolate the serving NMF solve at production K.

Measures the fixed-dictionary MU solve ALONE at K=115,200: one-utterance
F vs stacked 4-utterance F, f32 vs bf16 work dtype, fenced timings —
to decide whether batch-of-4 serving parity (0.99×) is a dispatch bug or
the compute roofline (enough F rows saturate the matmul units at this K,
making the solve FLOP-bound, so stacking frames scales time linearly).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

DATA = "/root/reference/data"
WARPS = ",".join(f"{w:g}" for w in
                 [0.86, 0.88, 0.90, 0.92, 0.94, 0.96, 0.98,
                  1.02, 1.04, 1.06, 1.08, 1.10, 1.12, 1.14])


def main():
    import jax
    import jax.numpy as jnp

    from exemplars_vc_tpu.config import load_config
    from exemplars_vc_tpu.factorize.nmf import nmf_activations
    from exemplars_vc_tpu.io import ArtifactStore, read_wav
    from exemplars_vc_tpu.io.store import list_speaker_wavs
    from exemplars_vc_tpu.pipelines.conv_dicts import extract_stft_features
    from exemplars_vc_tpu.pipelines.serve import Converter
    from exemplars_vc_tpu.runtime import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()
    print(f"platform: {jax.devices()[0].platform}", file=sys.stderr)

    cfg = load_config(overrides=[
        "data.tar=TF1", "misc.nb_file=8", f"data.dict_augment_warps={WARPS}",
    ])
    import tempfile

    tmp = tempfile.mkdtemp(prefix="evc_probe_")
    conv = Converter(cfg, ArtifactStore(tmp), DATA, nb_file=8)
    A, B = conv.dicts["stft"]
    K, D = A.shape
    print(f"dictionary: K={K} D={D}", file=sys.stderr)

    utts = list_speaker_wavs(DATA, "SF1")[:4]
    mags = []
    for p in utts:
        x, sr = read_wav(p)
        mags.append(jnp.asarray(extract_stft_features(x, cfg), jnp.float32))
    X1 = mags[0]
    X4 = jnp.concatenate(mags, axis=0)
    print(f"F1={X1.shape[0]} F4={X4.shape[0]}", file=sys.stderr)

    results = {"K": int(K), "D": int(D),
               "F1": int(X1.shape[0]), "F4": int(X4.shape[0])}

    def timed(tag, fn):
        out = fn()
        jax.block_until_ready(out.H)          # warm (compile)
        reps = 3
        t0 = time.time()
        for _ in range(reps):
            out = fn()
            jax.block_until_ready(out.H)
        dt = (time.time() - t0) / reps
        results[tag] = round(1000 * dt, 1)
        print(f"{tag}: {1000 * dt:.1f} ms", file=sys.stderr)
        return out

    for dtype, name in ((None, "f32"), (jnp.bfloat16, "bf16")):
        timed(f"solve_1utt_{name}_ms",
              lambda: nmf_activations(X1, A, tol=0.0, max_iter=80,
                                      work_dtype=dtype))
        timed(f"solve_4utt_{name}_ms",
              lambda: nmf_activations(X4, A, tol=0.0, max_iter=80,
                                      work_dtype=dtype))

    # arithmetic for the roofline verdict
    flops_per_iter_1 = 2 * 2 * results["F1"] * K * 256   # two K-matmuls, D→256
    results["model_flops_per_iter_1utt"] = flops_per_iter_1
    results["achieved_tflops_1utt_f32"] = round(
        80 * flops_per_iter_1 / (results["solve_1utt_f32_ms"] / 1e3) / 1e12, 2)
    results["achieved_tflops_4utt_f32"] = round(
        80 * flops_per_iter_1 * results["F4"] / results["F1"]
        / (results["solve_4utt_f32_ms"] / 1e3) / 1e12, 2)
    results["batch_scaling_f32"] = round(
        results["solve_4utt_f32_ms"] / results["solve_1utt_f32_ms"], 2)
    results["batch_scaling_bf16"] = round(
        results["solve_4utt_bf16_ms"] / results["solve_1utt_bf16_ms"], 2)

    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Serving and streaming latency benchmark.

Measures what bench.py (throughput) deliberately doesn't: per-request
latency of the production serving surfaces, with warm executables and
prepared device-resident dictionaries —

- **serving**: ``pipelines.serve.Converter.convert`` per-utterance wall
  latency (wav in → converted audio on host), p50/p90 over the bundled
  utterances plus the held-out 100162 pair, and the real-time factor
  (audio seconds per second of latency);
- **streaming**: ``pipelines.stream.StreamingConverter.push`` per-chunk
  latency at a fixed chunk size (frames → audio out), p50/p90 steady-state,
  against the chunk's own audio duration (a push is real-time-capable when
  latency < chunk duration).

The reference has no serving story at all (its conversion reloads pickles
per run, ``04_align_n_nmf.py:251-302``); these numbers back the framework's
production-serving claim. The data is ``EVC_BENCH_DATA`` when set, else
the seeded corpus of ``io/synth_corpus.py``; the run needs a GPU. Prints
ONE JSON line; ``--out`` also writes it.

Usage: python bench_serving.py [--repeats 3] [--chunk-frames 16] [--out f]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np


def log(m):
    print(m, file=sys.stderr, flush=True)


def pct(vals, q):
    v = sorted(vals)
    return v[min(len(v) - 1, int(q * len(v)))]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--chunk-frames", type=int, default=16)
    ap.add_argument("--stream-pushes", type=int, default=30)
    ap.add_argument("--synth-iters", type=int, default=60,
                    help="Griffin-Lim budget for the latency paths (300 is "
                    "the batch default; 60 is the measured quality/latency "
                    "knee)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax.numpy as jnp

    from exemplars_vc_tpu.config import load_config
    from exemplars_vc_tpu.io import ArtifactStore, read_wav
    from exemplars_vc_tpu.io.store import list_speaker_wavs
    from exemplars_vc_tpu.pipelines.evaluate import heldout_pair
    from exemplars_vc_tpu.pipelines.serve import Converter
    from exemplars_vc_tpu.io.synth_corpus import bench_data
    from exemplars_vc_tpu.pipelines.stream import StreamingConverter
    from exemplars_vc_tpu.runtime import (
        device_record,
        enable_persistent_compilation_cache,
        require_gpu,
    )

    require_gpu()
    enable_persistent_compilation_cache()
    device = device_record()
    log(f"device: {device}")
    DATA = bench_data()

    cfg = load_config(overrides=["data.tar=TF1", "misc.nb_file=8"])
    tmp = tempfile.mkdtemp(prefix="evc_serve_bench_")
    t0 = time.time()
    conv = Converter(cfg, ArtifactStore(tmp), DATA, nb_file=8)
    prepare_s = time.time() - t0

    utts = list_speaker_wavs(DATA, "SF1")[:8]
    heldout_src, _ = heldout_pair(DATA)
    if os.path.isfile(heldout_src):
        utts = utts + [heldout_src]

    # warm every shape bucket once (compile pass — persistent-cached)
    t0 = time.time()
    for p in utts:
        conv.convert(p, synth_iters=args.synth_iters)
    warm_s = time.time() - t0
    log(f"prepare {prepare_s:.2f}s, warm pass over {len(utts)} utts {warm_s:.2f}s")

    # ---- serving latency --------------------------------------------------
    lats, rtfs = [], []
    for _ in range(args.repeats):
        for p in utts:
            x, sr = read_wav(p)
            t0 = time.time()
            conv.convert(p, synth_iters=args.synth_iters)
            dt = time.time() - t0
            lats.append(dt)
            rtfs.append((len(x) / sr) / dt)
    serving = {
        "n_requests": len(lats),
        "p50_ms": round(1000 * pct(lats, 0.5), 1),
        "p90_ms": round(1000 * pct(lats, 0.9), 1),
        "max_ms": round(1000 * max(lats), 1),
        "rtf_p50": round(pct(rtfs, 0.5), 1),  # audio-s per wall-s, per request
    }
    log(f"serving: {serving}")

    # ---- batch serving throughput -----------------------------------------
    batch_utts = utts[:8]
    conv.convert_batch(batch_utts, synth_iters=args.synth_iters)  # warm
    batch_times = []
    for _ in range(args.repeats):
        t0 = time.time()
        res = conv.convert_batch(batch_utts, synth_iters=args.synth_iters)
        batch_times.append(time.time() - t0)
    bt = sorted(batch_times)[len(batch_times) // 2]
    batch_audio = sum(read_wav(p)[0].shape[0] for p in batch_utts) / sr
    batch = {
        "n_utts": len(batch_utts),
        "wall_s_median": round(bt, 3),
        "per_utt_ms": round(1000 * bt / len(batch_utts), 1),
        "rtf": round(batch_audio / bt, 1),
    }
    log(f"batch: {batch}")

    # ---- streaming chunk latency -------------------------------------------
    from exemplars_vc_tpu.pipelines.conv_dicts import extract_stft_features

    A, B = (np.asarray(a) for a in conv.dicts["stft"])
    sc = StreamingConverter(cfg, A, B, synth_iters=args.synth_iters)
    x, sr = read_wav(utts[-1])
    mag = np.asarray(extract_stft_features(jnp.asarray(x, jnp.float32), cfg))
    cf = args.chunk_frames
    n_chunks = min(args.stream_pushes, mag.shape[0] // cf)
    chunk_audio_ms = 1000.0 * cf * cfg.mcep.hop_length / sr
    # steady state: skip the first 3 pushes (context still growing → compiles)
    push_lats = []
    for i in range(n_chunks):
        chunk = mag[i * cf:(i + 1) * cf]
        t0 = time.time()
        y = sc.push(chunk)
        dt = time.time() - t0
        assert y.shape[0] == cf * cfg.mcep.hop_length
        if i >= 3:
            push_lats.append(dt)
    streaming = {
        "chunk_frames": cf,
        "chunk_audio_ms": round(chunk_audio_ms, 1),
        "n_pushes": len(push_lats),
        "p50_ms": round(1000 * pct(push_lats, 0.5), 1),
        "p90_ms": round(1000 * pct(push_lats, 0.9), 1),
        "realtime_capable_p90": bool(1000 * pct(push_lats, 0.9) < chunk_audio_ms),
    }
    log(f"streaming: {streaming}")

    shutil.rmtree(tmp, ignore_errors=True)
    payload = json.dumps({
        "device": device,
        "synth_iters": args.synth_iters,
        "prepare_s": round(prepare_s, 2),
        "serving": serving,
        "batch": batch,
        "streaming": streaming,
    })
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
    print(payload, flush=True)


if __name__ == "__main__":
    main()

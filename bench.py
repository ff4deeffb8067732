#!/usr/bin/env python
"""Headline benchmark: end-to-end exemplar VC throughput on one GPU.

Measures the full SF1→TF1 pipeline on 8 parallel pairs — speaker load,
alignment features, batched wavefront DTW dictionary build, conversion
features, fixed-dictionary NMF (max_iter=150, tol=1e-4 — the reference's
solver budget), conversion, and Griffin-Lim(300) synthesis — and reports
**audio-seconds processed per wall second** (the BASELINE.json metric).

The data is ``EVC_BENCH_DATA`` when set, else the seeded corpus of
``io/synth_corpus.py``. The converted utterance is the held-out pair
(``SF1_100162``, the reference's own eval id, ``04_align_n_nmf.py:439-440``),
which is NOT in the dictionary-build set; its DTW-aligned MCD vs the true
target is reported alongside throughput (computed outside the timed region).
The run needs a GPU and fails without one.

Baseline derivation (BASELINE.md): the reference's committed logs show the
dictionary build at ~75 s wall for 20 utterance pairs (~40 utts × ~3.5 s ≈
140 audio-s → 1.87 audio-s/s) and cached-dict conversion + Griffin-Lim(300)
at ~10 s for one ~3.5 s utterance (0.35 audio-s/s). Combined reference rate
≈ (140 + 3.5) / (75 + 10) ≈ 1.69 audio-s/s on a multi-core host.

Prints ONE JSON line to stdout; progress goes to stderr. Run 1 pays XLA
compilation (through the persistent executable cache — "cold" is labeled
with the cache state); runs 2..N are the steady-state measurement, run N+1
is a fenced run whose per-stage device times are reported as
``stages_synced_s`` (the async split's solver stage is dispatch-only by
design — the NMF drains inside synthesis — hence the separate synced view).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

REF_RATE_AUDIO_S_PER_S = 1.69


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_pipeline(cfg, store, data, wav_path, sync_stages=False):
    from exemplars_vc_tpu.pipelines.convert import convert_utterance

    res = convert_utterance(cfg, store, data, wav_path, nb_file=8,
                            sync_stages=sync_stages)
    return res


def main():
    from exemplars_vc_tpu.config import load_config
    from exemplars_vc_tpu.io import ArtifactStore, read_wav
    from exemplars_vc_tpu.io.store import list_speaker_wavs
    from exemplars_vc_tpu.io.synth_corpus import bench_data
    from exemplars_vc_tpu.pipelines.evaluate import heldout_pair
    from exemplars_vc_tpu.runtime import (
        device_record,
        enable_persistent_compilation_cache,
        require_gpu,
    )

    require_gpu()
    device = device_record()
    log(f"device: {device}")

    cache_dir = enable_persistent_compilation_cache()
    cache_entries_before = (
        len(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else 0
    )
    log(f"persistent XLA cache: {cache_dir} ({cache_entries_before} entries)")

    t_start = time.time()
    cfg = load_config(overrides=["data.tar=TF1", "misc.nb_file=8"])
    # the converted utterance is the reference's own HELD-OUT eval pair
    # (100162, 04_align_n_nmf.py:439-440) — not in the dictionary-build set
    data = bench_data()
    wav_path, tar_path = heldout_pair(data)

    # audio seconds the pipeline touches: both speakers' dictionaries + input
    total_audio = 0.0
    for spk in ("SF1", "TF1"):
        for p in list_speaker_wavs(data, spk)[:8]:
            x, sr = read_wav(p)
            total_audio += len(x) / sr
    x_in, sr = read_wav(wav_path)
    total_audio += len(x_in) / sr

    log(f"audio to process: {total_audio:.1f} s")

    # ---- run 1: cold (compiles everything) ---------------------------------
    tmp1 = tempfile.mkdtemp(prefix="evc_bench1_")
    t0 = time.time()
    run_pipeline(cfg, ArtifactStore(tmp1), data, wav_path)
    cold = time.time() - t0
    shutil.rmtree(tmp1, ignore_errors=True)
    log(f"cold run (incl. compile): {cold:.2f} s")

    # ---- runs 2..N: steady state, median-of-N ------------------------------
    # a single sample under-/over-states the framework, so the recorded
    # number is the MEDIAN of n_hot runs with per-stage p50/p90 alongside.
    n_hot = int(os.environ.get("EVC_BENCH_RUNS", "3"))
    hots, stage_samples = [], []
    for k in range(n_hot):
        tmp2 = tempfile.mkdtemp(prefix=f"evc_bench2_{k}_")
        t0 = time.time()
        res = run_pipeline(cfg, ArtifactStore(tmp2), data, wav_path)
        hots.append(time.time() - t0)
        stage_samples.append(res.timings)
        shutil.rmtree(tmp2, ignore_errors=True)
        log(f"steady-state run {k + 1}/{n_hot}: {hots[-1]:.2f} s  "
            f"stage timings: {res.timings}")

    hots_sorted = sorted(hots)
    hot = hots_sorted[len(hots_sorted) // 2]  # median
    stages = {}
    for name in stage_samples[0]:
        vals = sorted(s[name] for s in stage_samples)
        stages[name] = {
            "p50": round(vals[len(vals) // 2], 3),
            "p90": round(vals[min(len(vals) - 1, int(0.9 * len(vals)))], 3),
        }

    # ---- one fenced run: per-stage DEVICE times (interpretable split) ------
    # the async split above is production behavior (NMF drains inside the
    # synthesis block); this run fences every stage so each number is the
    # stage's own device time
    tmp3 = tempfile.mkdtemp(prefix="evc_bench3_")
    res_sync = run_pipeline(cfg, ArtifactStore(tmp3), data, wav_path,
                            sync_stages=True)
    shutil.rmtree(tmp3, ignore_errors=True)
    stages_synced = {k: round(v, 3) for k, v in res_sync.timings.items()}
    log(f"fenced stage timings: {stages_synced}")

    # held-out conversion quality (outside the timed region): DTW-aligned
    # MCD vs the true held-out target utterance
    from exemplars_vc_tpu.pipelines.convert import mcd_between_signals

    tar_sig, _ = read_wav(tar_path)
    heldout_mcd = mcd_between_signals(res_sync.audio, tar_sig, cfg)
    log(f"held-out MCD vs {os.path.basename(tar_path)}: {heldout_mcd:.2f} dB")

    rate = total_audio / hot
    print(json.dumps({
        "metric": "audio-seconds/s per GPU (dict build + NMF convert + GL300)",
        "value": round(rate, 3),
        "unit": "audio_s/s",
        "vs_baseline": round(rate / REF_RATE_AUDIO_S_PER_S, 3),
        "detail": {
            "steady_state_s_median": round(hot, 3),
            "steady_state_s_all": [round(h, 3) for h in hots],
            "cold_s": round(cold, 3),
            "xla_cache_entries_at_start": cache_entries_before,
            "audio_s": round(total_audio, 2),
            "heldout_utt": "100162 (not in dictionary-build set)",
            "heldout_mcd_db": round(float(heldout_mcd), 3),
            "stages_async_dispatch_s": stages,
            "stages_synced_s": stages_synced,
            "device": device,
            "total_wall_s": round(time.time() - t_start, 1),
        },
    }), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Production-scale (100k+ exemplar) end-to-end conversion benchmark.

BASELINE config 5 is "100k+-frame sharded-dictionary conversion"; its
single-GPU half is measured here: run the WHOLE convert path — dictionary
build, VTLP expansion to ~100k exemplar pairs, fixed-dictionary NMF solve
at production K, conversion, Griffin-Lim(300) — on the GPU, and report
audio-s/s + the fenced stage split next to the base-dictionary number
(bench.py). The data is ``EVC_BENCH_DATA`` when set, else the seeded corpus
of ``io/synth_corpus.py``.

The large dictionary comes from ``data.dict_augment_warps`` (14 VTLP warps
→ 15 × the base dictionary's exemplars from the same audio) — the same
mechanism a production corpus would use for coverage.

Usage: python bench_100k.py [--runs 3] [--out FILE]
"""

from __future__ import annotations

import argparse
import json

import shutil
import sys
import tempfile
import time

WARPS = ",".join(
    f"{w:g}" for w in
    [0.86, 0.88, 0.90, 0.92, 0.94, 0.96, 0.98,
     1.02, 1.04, 1.06, 1.08, 1.10, 1.12, 1.14]
)


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--warps", default=WARPS,
                    help="comma list of VTLP warps (smaller for smoke tests)")
    args = ap.parse_args()

    from exemplars_vc_tpu.config import load_config
    from exemplars_vc_tpu.io import ArtifactStore, read_wav
    from exemplars_vc_tpu.io.store import list_speaker_wavs
    from exemplars_vc_tpu.pipelines.convert import (
        _aligned_dicts,
        convert_utterance,
        mcd_between_signals,
    )
    from exemplars_vc_tpu.io.synth_corpus import bench_data
    from exemplars_vc_tpu.pipelines.evaluate import heldout_pair
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

    cfg = load_config(overrides=[
        "data.tar=TF1", "misc.nb_file=8",
        f"data.dict_augment_warps={args.warps}",
    ])
    wav_path, tar_path = heldout_pair(DATA)

    total_audio = 0.0
    for spk in ("SF1", "TF1"):
        for p in list_speaker_wavs(DATA, spk)[:8]:
            x, sr = read_wav(p)
            total_audio += len(x) / sr
    x_in, sr = read_wav(wav_path)
    total_audio += len(x_in) / sr

    # cold run (fresh store, compiles at production K)
    tmp = tempfile.mkdtemp(prefix="evc_100k_cold_")
    t0 = time.time()
    res = convert_utterance(cfg, ArtifactStore(tmp), DATA, wav_path, nb_file=8)
    cold = time.time() - t0
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"cold: {cold:.2f} s")

    hots = []
    for k in range(args.runs):
        tmp = tempfile.mkdtemp(prefix=f"evc_100k_{k}_")
        t0 = time.time()
        res = convert_utterance(cfg, ArtifactStore(tmp), DATA, wav_path,
                                nb_file=8)
        hots.append(time.time() - t0)
        shutil.rmtree(tmp, ignore_errors=True)
        log(f"run {k + 1}/{args.runs}: {hots[-1]:.2f} s  {res.timings}")

    # one fenced run for the honest stage split + K + quality
    tmp = tempfile.mkdtemp(prefix="evc_100k_sync_")
    store = ArtifactStore(tmp)
    res_sync = convert_utterance(cfg, store, DATA, wav_path,
                                 nb_file=8, sync_stages=True)
    # the memoized dictionaries of this run: A's row count is K
    k_exemplars = int(_aligned_dicts(cfg, store, DATA, 8)[0]["stft"][0].shape[0])
    shutil.rmtree(tmp, ignore_errors=True)

    tar_sig, _ = read_wav(tar_path)
    heldout_mcd = float(mcd_between_signals(res_sync.audio, tar_sig, cfg))

    # batch-vs-serial serving at production K: the stacked convert_batch
    # solve amortizes the NMF across utterances, a win that grows with K;
    # this measures whether 100k+ K is the regime where batch pays.
    from exemplars_vc_tpu.pipelines.serve import Converter

    from dataclasses import replace as _replace

    serving = {"n_utts": 4, "synth_iters": 60}
    batch_utts = list_speaker_wavs(DATA, "SF1")[:4]
    for dtype in ("float32", "bfloat16"):
        cfg_s = _replace(cfg, nmf=_replace(cfg.nmf, work_dtype=dtype))
        tmpb = tempfile.mkdtemp(prefix="evc_100k_serve_")
        conv = Converter(cfg_s, ArtifactStore(tmpb), DATA, nb_file=8)
        conv.convert_batch(batch_utts, synth_iters=60)    # warm
        for p in batch_utts:
            conv.convert(p, synth_iters=60)               # warm serial shapes
        t0 = time.time()
        conv.convert_batch(batch_utts, synth_iters=60)
        batch_s = time.time() - t0
        t0 = time.time()
        for p in batch_utts:
            conv.convert(p, synth_iters=60)
        serial_s = time.time() - t0
        shutil.rmtree(tmpb, ignore_errors=True)
        tag = "" if dtype == "float32" else "_bf16"
        serving.update({
            f"batch_per_utt_ms{tag}": round(1000 * batch_s / len(batch_utts), 1),
            f"serial_per_utt_ms{tag}": round(1000 * serial_s / len(batch_utts), 1),
            f"batch_speedup{tag}": round(serial_s / batch_s, 2),
        })
    log(f"serving at K={k_exemplars}: {serving}")

    hot = sorted(hots)[len(hots) // 2]
    payload = {
        "metric": f"audio-seconds/s per GPU, {k_exemplars}-exemplar "
                  "dictionary (dict build + VTLP expansion + NMF convert + GL300)",
        "value": round(total_audio / hot, 3),
        "unit": "audio_s/s",
        "detail": {
            "k_exemplars": k_exemplars,
            "steady_state_s_median": round(hot, 3),
            "steady_state_s_all": [round(h, 3) for h in hots],
            "cold_s": round(cold, 3),
            "audio_s": round(total_audio, 2),
            "stages_synced_s": {k: round(v, 3)
                                for k, v in res_sync.timings.items()},
            "heldout_mcd_db": round(heldout_mcd, 3),
            "nmf_iters": int(res_sync.n_iter),
            "serving_batch_vs_serial": serving,
            "device": device,
        },
    }
    s = json.dumps(payload)
    if args.out:
        with open(args.out, "w") as f:
            f.write(s + "\n")
    print(s, flush=True)


if __name__ == "__main__":
    main()

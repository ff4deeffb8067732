"""Profile the dictionary-build stage sub-steps with device fences.

Its findings drove the pair-fused dispatches and the scalar-only DTW
sync, and the sub-steps mirror that structure:
pair-fused alignment features / DTW compute / per-pair scalar sync /
pair-fused conversion features / exemplar gather, each fenced, plus the
artifact-store flush cost (the bench builds into a FRESH store every run,
so the async npz writes d2h their payloads during the stage).

Run on the GPU: ``python tools/profile_dicts.py``; add ``--cpu`` for
the CPU backend. Prints one JSON object.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

from exemplars_vc_tpu.runtime import enable_persistent_compilation_cache

enable_persistent_compilation_cache()

import jax
import numpy as np

DATA = "/root/reference/data"


def fenced(fn):
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def one_build(cfg, store, flush_store=True):
    """One full dictionary preparation with per-substep fences (round-5
    structure: pair-fused feature dispatches, device-resident index paths,
    scalar-only DTW sync)."""
    from exemplars_vc_tpu.align import dtw_batch
    from exemplars_vc_tpu.align.exemplar import build_exemplar_dicts_padded
    from exemplars_vc_tpu.pipelines.conv_dicts import build_conversion_dicts_pair
    from exemplars_vc_tpu.pipelines.make_dict import (
        _extract_pair_stacked,
        _pack_scalars,
    )

    t = {}
    # speaker audio: device-resident signal cache (uploads once per process)
    ((FA, la), (FB, lb)), dt = fenced(
        lambda: _extract_pair_stacked(cfg, DATA, 8))
    t["align_feats_pair"] = dt

    r, dt = fenced(lambda: dtw_batch(FA, FB, la, lb))
    t["dtw_compute"] = dt
    t0 = time.perf_counter()
    N = r.path_i.shape[0]
    small = np.asarray(_pack_scalars(r.path_len, r.distance))
    t["dtw_scalar_sync"] = time.perf_counter() - t0
    path_len = small[:N]

    (sfeats, tfeats), dt = fenced(lambda: build_conversion_dicts_pair(
        cfg, store, DATA, "SF1", "TF1", nb_file=8))
    t["conv_feats_pair"] = dt
    sf, tf_ = sfeats.feats["stft"], tfeats.feats["stft"]

    k_true = int(path_len.sum())
    k_pad = ((k_true + 511) // 512) * 512
    (A, B), dt = fenced(lambda: build_exemplar_dicts_padded(
        sf, tf_, r.path_i, r.path_j, k_pad=k_pad))
    t["exemplar_gather"] = dt

    # store-write drain: wait for the async artifact writer to finish so the
    # next build's numbers aren't polluted by this build's d2h transfers
    t0 = time.perf_counter()
    if flush_store and hasattr(store, "flush"):
        store.flush()
    t["store_flush_wait"] = time.perf_counter() - t0
    t["total"] = sum(v for k, v in t.items())
    return {k: round(v, 4) for k, v in t.items()}


def main():
    from exemplars_vc_tpu.config import load_config
    from exemplars_vc_tpu.io import ArtifactStore
    from exemplars_vc_tpu.pipelines.convert import _aligned_dicts

    cfg = load_config(overrides=["data.tar=TF1", "misc.nb_file=8"])
    runs = []
    for k in range(4):
        store = ArtifactStore(tempfile.mkdtemp(prefix=f"evc_prof_{k}_"))
        runs.append(one_build(cfg, store))
        print(f"build {k}: {runs[-1]}", file=sys.stderr, flush=True)

    # reference: the production _aligned_dicts wall time into a fresh store
    t0 = time.perf_counter()
    store = ArtifactStore(tempfile.mkdtemp(prefix="evc_prof_ad_"))
    dicts, _ = _aligned_dicts(cfg, store, DATA, 8)
    jax.block_until_ready(dicts)
    aligned = time.perf_counter() - t0

    print(json.dumps({
        "platform": jax.devices()[0].platform,
        "builds": runs,
        "aligned_dicts_fresh_store_s": round(aligned, 4),
    }, indent=1), flush=True)


if __name__ == "__main__":
    main()

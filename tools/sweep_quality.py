#!/usr/bin/env python
"""Joint quality-lever sweep over LOO folds.

The round-3/4 levers were measured one-at-a-time; this sweeps COMPOSED
configurations of the individually-winning levers (KL β-loss base + VTLP
warp density × dictionary densify × post-solve refinements) over a chosen
set of leave-one-out folds, reusing the LOO fold machinery. Run the sweep
on the CPU backend (2 folds) to pick a winner, then validate the winner on
all 8 folds on the GPU.

Usage:
  python tools/sweep_quality.py --platform cpu --folds 100001,100002
  python tools/sweep_quality.py --configs quality --folds all   # validate
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATA = "/root/reference/data"


def combo_overrides() -> dict[str, dict[str, str]]:
    """Each combo = overrides applied on top of the stft_quality (KL) base."""
    w2 = "0.9,1.1"
    w4 = "0.9,0.95,1.05,1.1"
    w6 = "0.88,0.92,0.96,1.04,1.08,1.12"
    return {
        "kl": {},
        "kl_vtlp2": {"data.dict_augment_warps": w2},
        "kl_vtlp4": {"data.dict_augment_warps": w4},
        "kl_vtlp6": {"data.dict_augment_warps": w6},
        "kl_vtlp2_dense2": {"data.dict_augment_warps": w2,
                            "data.dict_hop_divisor": "2"},
        "kl_vtlp4_dense2": {"data.dict_augment_warps": w4,
                            "data.dict_hop_divisor": "2"},
        "kl_vtlp2_topk": {"data.dict_augment_warps": w2,
                          "nmf.prune_topk": "64"},
        "kl_vtlp2_sharp": {"data.dict_augment_warps": w2,
                           "nmf.activation_power": "1.15"},
        "kl_vtlp2_smooth": {"data.dict_augment_warps": w2,
                            "nmf.h_smooth": "2"},
        # wave 2 around the wave-1 winner (kl_vtlp4)
        "kl_vtlp4_alt": {"data.dict_augment_warps": "0.92,0.96,1.04,1.08"},
        "kl_vtlp4_smooth": {"data.dict_augment_warps": "0.9,0.95,1.05,1.1",
                            "nmf.h_smooth": "2"},
        "kl_vtlp4_it300": {"data.dict_augment_warps": "0.9,0.95,1.05,1.1",
                           "nmf.max_iter": "300"},
        "kl_vtlp8": {"data.dict_augment_warps":
                     "0.88,0.92,0.95,0.97,1.03,1.05,1.08,1.12"},
        # wave 4: dictionary cleaning on top of the wave-2 winner
        "kl_vtlp4_smooth_prune10": {"data.dict_augment_warps":
                                    "0.9,0.95,1.05,1.1",
                                    "nmf.h_smooth": "2",
                                    "data.dict_prune_frac": "0.1"},
        "kl_vtlp4_smooth_prune20": {"data.dict_augment_warps":
                                    "0.9,0.95,1.05,1.1",
                                    "nmf.h_smooth": "2",
                                    "data.dict_prune_frac": "0.2"},
        "kl_vtlp4_smooth_prune35": {"data.dict_augment_warps":
                                    "0.9,0.95,1.05,1.1",
                                    "nmf.h_smooth": "2",
                                    "data.dict_prune_frac": "0.35"},
        # wave 3 around the wave-2 winner (kl_vtlp4_smooth)
        "kl_vtlp4_smooth3": {"data.dict_augment_warps": "0.9,0.95,1.05,1.1",
                             "nmf.h_smooth": "3"},
        "kl_vtlp6_smooth": {"data.dict_augment_warps":
                            "0.88,0.92,0.96,1.04,1.08,1.12",
                            "nmf.h_smooth": "2"},
        "kl_vtlp4_dense2_smooth": {"data.dict_augment_warps":
                                   "0.9,0.95,1.05,1.1",
                                   "data.dict_hop_divisor": "2",
                                   "nmf.h_smooth": "2"},
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--folds", default="100001,100002")
    ap.add_argument("--configs", default=None,
                    help="comma list of combo names (default all)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
        import jax

        jax.config.update("jax_platforms", args.platform)
    from exemplars_vc_tpu.runtime import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()
    import jax

    from exemplars_vc_tpu.config import load_config
    from exemplars_vc_tpu.io import ArtifactStore, read_wav
    from exemplars_vc_tpu.pipelines.convert import (
        convert_utterance,
        mcd_between_signals,
    )
    from exemplars_vc_tpu.pipelines.evaluate import (
        _configs,
        _fold_data_dir,
        loo_utterances,
    )

    combos = combo_overrides()
    names = (args.configs.split(",") if args.configs else list(combos))

    base_cfg = load_config(overrides=["data.tar=TF1", "misc.nb_file=8"])
    quality = _configs(base_cfg)["stft_quality"]

    from dataclasses import replace

    def apply(cfg, ov: dict[str, str]):
        for key, val in ov.items():
            sec, field = key.split(".")
            sub = getattr(cfg, sec)
            typ = type(getattr(sub, field))
            cfg = replace(cfg, **{sec: replace(sub, **{field: typ(val)})})
        return cfg

    root = tempfile.mkdtemp(prefix="evc_sweep_")
    store = ArtifactStore(root)
    utts = loo_utterances(DATA, "SF1", "TF1")
    if args.folds != "all":
        keep = set(args.folds.split(","))
        utts = [u for u in utts if u in keep]

    results = {n: {} for n in names}
    for utt in utts:
        fold_data = _fold_data_dir(root, DATA, base_cfg, utt)
        fold_store = ArtifactStore(os.path.join(root, "loo", f"store_wo_{utt}"))
        src_wav = os.path.join(DATA, "SF1", f"{utt}.wav")
        tar_wav = os.path.join(DATA, "TF1", f"{utt}.wav")
        for n in names:
            c = apply(quality, combos[n])
            t0 = time.time()
            res = convert_utterance(c, fold_store, fold_data, src_wav,
                                    reference_wav=tar_wav)
            mcd = float(res.mcd_vs_reference)
            results[n][utt] = round(mcd, 3)
            print(f"{utt} {n}: {mcd:.3f} dB ({time.time() - t0:.1f}s)",
                  file=sys.stderr, flush=True)

    import numpy as np

    summary = {n: {"mean": round(float(np.mean(list(v.values()))), 3),
                   "std": round(float(np.std(list(v.values()))), 3),
                   "n": len(v)}
               for n, v in results.items()}
    payload = {"platform": jax.devices()[0].platform,
               "folds": utts, "per_fold": results, "summary": summary}
    s = json.dumps(payload, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(s + "\n")
    print(s)


if __name__ == "__main__":
    main()

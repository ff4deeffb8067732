"""Generate tests/goldens/heldout_snapshot.npz — the held-out quality golden.

Run from the repo root (CPU backend, the same backend CI uses):

    python -m tests.oracles.make_heldout_golden [--store DIR]

Protocol: convert the reference's own held-out eval
utterance (100162, ``04_align_n_nmf.py:439-440``) with the 8-pair bundled
dictionaries under the four canonical configs of
``pipelines.evaluate._configs`` and record the DTW-aligned MCD vs the true
held-out target, plus the no-conversion baseline. ``--store`` may point at a
warm ArtifactStore to skip the dictionary rebuild.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")

OUT = os.path.join(os.path.dirname(__file__), "..", "goldens",
                   "heldout_snapshot.npz")
SYNTH_ITERS = 60


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", default=None)
    ap.add_argument("--data", default="/root/reference/data")
    args = ap.parse_args()

    from exemplars_vc_tpu.config import load_config
    from exemplars_vc_tpu.io import ArtifactStore
    from exemplars_vc_tpu.pipelines.evaluate import (
        evaluate_heldout,
        no_conversion_baseline,
    )

    cfg = load_config(overrides=["data.tar=TF1", "misc.nb_file=8"])
    store_dir = args.store or tempfile.mkdtemp(prefix="evc_golden_")
    scores = evaluate_heldout(cfg, ArtifactStore(store_dir), args.data,
                              nb_file=8, synth_iters=SYNTH_ITERS,
                              compare_reference_outputs=False)
    out = {f"{name}_mcd": np.float32(s.mcd) for name, s in scores.items()}
    out["no_conversion_mcd"] = np.float32(no_conversion_baseline(cfg, args.data))
    out["synth_iters"] = np.int32(SYNTH_ITERS)
    np.savez(OUT, **out)
    print({k: float(v) for k, v in out.items()})
    print("wrote", os.path.abspath(OUT))


if __name__ == "__main__":
    main()

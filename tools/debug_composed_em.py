#!/usr/bin/env python
"""Composed source-F0-filter EM: platform sensitivity under IDENTICAL inputs.

The stereo-SIMM fix proved that solver platform-exact; the composed path
still showed a lead-share spread between an accelerator and the CPU
(0.684 vs 0.744). This isolates
the EM: fit_multichannel_sf on bit-identical inputs (host-f64 STFT of the
bench mixture, PRNG-keyed inits) on the current backend, dumping the NLL
trajectory and final-factor summaries for cross-platform diffing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ap = argparse.ArgumentParser()
ap.add_argument("--platform", default=None)
ap.add_argument("--out", default="/tmp/composed_em.json")
args = ap.parse_args()
if args.platform:
    os.environ["JAX_PLATFORMS"] = args.platform

import jax

if args.platform:
    jax.config.update("jax_platforms", args.platform)

import jax.numpy as jnp
import numpy as np

import bench_separate
from exemplars_vc_tpu.runtime import enable_persistent_compilation_cache
from exemplars_vc_tpu.separate.glue import host_stft_stack, unit_power
from exemplars_vc_tpu.separate.lead import hann_filter_basis, harmonic_dictionary
from exemplars_vc_tpu.separate.lead_multichannel import fit_multichannel_sf

enable_persistent_compilation_cache()
print(f"platform: {jax.devices()[0].platform}", file=sys.stderr)

x = bench_separate.synthetic_mixture()
n_fft, hop = 1024, 256
X = host_stft_stack(x, n_fft, hop, fnc=True)
X_fit = unit_power(X)
F = X.shape[0]

n_steps = int(np.ceil(12 * 4 * np.log2(8.0))) + 1
f0_grid = 100.0 * 2.0 ** (np.arange(n_steps) / 48.0)
WF0 = harmonic_dictionary(f0_grid, n_fft, 16000.0, 30)
WGAMMA = hann_filter_basis(F, 20)

m = fit_multichannel_sf(X_fit, WF0, WGAMMA, n_acc_sources=1, n_filters=4,
                        n_acc_components=20, n_em=10,
                        key=jax.random.PRNGKey(2))
out = {
    "nll": [float(v) for v in np.asarray(m.neg_log_like)],
    "sum_hf0": float(np.asarray(jnp.sum(m.HF0))),
    "sum_fw": float(np.asarray(jnp.sum(m.FW))),
    "sum_tw": float(np.asarray(jnp.sum(m.TW))),
    "sum_w": float(np.asarray(jnp.sum(m.W))),
    "sum_h": float(np.asarray(jnp.sum(m.H))),
    "lead_share_model": float(np.asarray(
        jnp.sum(jnp.dot(WF0, m.HF0) * jnp.dot(jnp.dot(WGAMMA, m.FW), m.TW))
        / (jnp.sum(jnp.dot(WF0, m.HF0)
                   * jnp.dot(jnp.dot(WGAMMA, m.FW), m.TW))
           + jnp.sum(jnp.einsum("jfk,jkn->jfn", m.W, m.H))))),
}
with open(args.out, "w") as f:
    json.dump(out, f, indent=1)
print(json.dumps(out))

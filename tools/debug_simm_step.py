#!/usr/bin/env python
"""One-iteration intermediate dump: device f32 vs numpy float64.

Computes every intermediate of the FIRST stereo-SIMM warmup iteration
(HF0 → HPHI → alpha updates; accompaniment frozen) on the active JAX
backend as one jitted program, fetches each, and compares against a
float64 numpy recomputation of the same quantities from the same inits.
The first intermediate with large relative error is the culprit op family.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

ap = argparse.ArgumentParser()
ap.add_argument("--platform", default=None)
args = ap.parse_args()
if args.platform:
    os.environ["JAX_PLATFORMS"] = args.platform

import jax

if args.platform:
    jax.config.update("jax_platforms", args.platform)

import jax.numpy as jnp
import numpy as np
from functools import partial

import bench_separate
from exemplars_vc_tpu.runtime import enable_persistent_compilation_cache
from exemplars_vc_tpu.separate.glue import stereo_powers, stft_stack
from exemplars_vc_tpu.separate.lead import hann_filter_basis, harmonic_dictionary

enable_persistent_compilation_cache()
print(f"platform: {jax.devices()[0].platform}", file=sys.stderr)

SR, n_fft, hop = 16000.0, 1024, 256
f0_min, f0_max, steps = 100.0, 800.0, 4
n_accomp = 20
n_filters, n_filt_atoms, n_harm = 4, 20, 30
EPS = 1e-20

x = jnp.asarray(bench_separate.synthetic_mixture())
X = stft_stack(x, n_fft, hop, fnc=False)
SXRj, SXLj = stereo_powers(X)
F, N = SXRj.shape

n_steps = int(np.ceil(12 * steps * np.log2(f0_max / f0_min))) + 1
f0_grid = f0_min * 2.0 ** (np.arange(n_steps) / (12.0 * steps))
WF0j = harmonic_dictionary(f0_grid, n_fft, SR, n_harm)
WGAMMAj = hann_filter_basis(F, n_filt_atoms)
k1, _ = jax.random.split(jax.random.PRNGKey(1))
ks = jax.random.split(k1, 6)
HGAMMAj = jnp.abs(jax.random.normal(ks[0], (n_filt_atoms, n_filters))).astype(jnp.float32)
HPHIj = jnp.abs(jax.random.normal(ks[1], (n_filters, N))).astype(jnp.float32)
HF0j = jnp.abs(jax.random.normal(ks[2], (WF0j.shape[1], N))).astype(jnp.float32)
WMj = jnp.full((F, n_accomp), 1e-3, jnp.float32)
HMj = jnp.full((n_accomp, N), 1e-3, jnp.float32)
bRj = jax.random.uniform(ks[5], (n_accomp,), dtype=jnp.float32)
betaj = jnp.stack([bRj, 1.0 - bRj])
alphaj = jnp.array([0.5, 0.5], jnp.float32)


@jax.jit
def one_iter(SXR, SXL, WF0, WGAMMA, alpha, HGAMMA, HPHI, HF0, beta, HM, WM):
    with jax.default_matmul_precision("highest"):
        dot = partial(jnp.dot, preferred_element_type=jnp.float32)
        out = {}

        def recon(HPHI, HF0):
            SF0 = dot(WF0, HF0)
            SPHI = dot(dot(WGAMMA, HGAMMA), HPHI)
            lead = SF0 * SPHI
            accR = dot(WM * (beta[0] ** 2), HM)
            accL = dot(WM * (beta[1] ** 2), HM)
            hatR = jnp.maximum(alpha[0] ** 2 * lead + accR, EPS)
            hatL = jnp.maximum(alpha[1] ** 2 * lead + accL, EPS)
            return SF0, SPHI, lead, hatR, hatL

        SF0, SPHI, lead, hatR, hatL = recon(HPHI, HF0)
        out["a_SF0"], out["a_SPHI"], out["a_lead"] = SF0, SPHI, lead
        out["a_hatR"], out["a_hatL"] = hatR, hatL
        comR = alpha[0] ** 2 * SPHI / hatR
        comL = alpha[1] ** 2 * SPHI / hatL
        num = comR * SXR / hatR + comL * SXL / hatL
        den = comR + comL
        out["b_comR"], out["b_num"], out["b_den"] = comR, num, den
        tnum = dot(WF0.T, num)
        tden = dot(WF0.T, den)
        out["c_tnum"], out["c_tden"] = tnum, tden
        ratio = tnum / jnp.maximum(tden, EPS)
        out["d_ratio"] = ratio
        HF0 = HF0 * ratio
        out["e_HF0"] = HF0

        SF0, SPHI, lead, hatR, hatL = recon(HPHI, HF0)
        out["f_hatR2"] = hatR
        comR = alpha[0] ** 2 * SF0 / hatR
        comL = alpha[1] ** 2 * SF0 / hatL
        num = comR * SXR / hatR + comL * SXL / hatL
        den = comR + comL
        WPHI = dot(WGAMMA, HGAMMA)
        t2n = dot(WPHI.T, num)
        t2d = dot(WPHI.T, den)
        out["g_t2n"], out["g_t2d"] = t2n, t2d
        HPHI = HPHI * (t2n / jnp.maximum(t2d, EPS))
        out["h_HPHI"] = HPHI
        return out


outs = one_iter(SXRj, SXLj, WF0j, WGAMMAj, alphaj, HGAMMAj, HPHIj, HF0j,
                betaj, HMj, WMj)
outs = {k: np.asarray(v, np.float64) for k, v in outs.items()}

# ---- float64 recomputation from the SAME (f32-rounded) inits --------------
SXR = np.asarray(SXRj, np.float64)
SXL = np.asarray(SXLj, np.float64)
WF0 = np.asarray(WF0j, np.float64)
WGAMMA = np.asarray(WGAMMAj, np.float64)
HGAMMA = np.asarray(HGAMMAj, np.float64)
HPHI = np.asarray(HPHIj, np.float64)
HF0 = np.asarray(HF0j, np.float64)
WM = np.asarray(WMj, np.float64)
HM = np.asarray(HMj, np.float64)
beta = np.asarray(betaj, np.float64)
alpha = np.asarray(alphaj, np.float64)

ref = {}


def recon64(HPHI, HF0):
    SF0 = WF0 @ HF0
    SPHI = (WGAMMA @ HGAMMA) @ HPHI
    lead = SF0 * SPHI
    accR = (WM * beta[0] ** 2) @ HM
    accL = (WM * beta[1] ** 2) @ HM
    hatR = np.maximum(alpha[0] ** 2 * lead + accR, EPS)
    hatL = np.maximum(alpha[1] ** 2 * lead + accL, EPS)
    return SF0, SPHI, lead, hatR, hatL


SF0, SPHI, lead, hatR, hatL = recon64(HPHI, HF0)
ref["a_SF0"], ref["a_SPHI"], ref["a_lead"] = SF0, SPHI, lead
ref["a_hatR"], ref["a_hatL"] = hatR, hatL
comR = alpha[0] ** 2 * SPHI / hatR
comL = alpha[1] ** 2 * SPHI / hatL
num = comR * SXR / hatR + comL * SXL / hatL
den = comR + comL
ref["b_comR"], ref["b_num"], ref["b_den"] = comR, num, den
tnum = WF0.T @ num
tden = WF0.T @ den
ref["c_tnum"], ref["c_tden"] = tnum, tden
ratio = tnum / np.maximum(tden, EPS)
ref["d_ratio"] = ratio
HF0 = HF0 * ratio
ref["e_HF0"] = HF0
SF0, SPHI, lead, hatR, hatL = recon64(HPHI, HF0)
ref["f_hatR2"] = hatR
comR = alpha[0] ** 2 * SF0 / hatR
comL = alpha[1] ** 2 * SF0 / hatL
num = comR * SXR / hatR + comL * SXL / hatL
den = comR + comL
WPHI = WGAMMA @ HGAMMA
t2n = WPHI.T @ num
t2d = WPHI.T @ den
ref["g_t2n"], ref["g_t2d"] = t2n, t2d
HPHI = HPHI * (t2n / np.maximum(t2d, EPS))
ref["h_HPHI"] = HPHI

print(f"{'stage':12s} {'max_rel':>12s} {'rel@energy':>12s} "
      f"{'dev_min':>10s} {'ref_min':>10s} {'ref_max':>10s}")
for k in sorted(ref):
    a, b = outs[k], ref[k]
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    # weighted view: relative error at entries that carry the energy
    mask = np.abs(b) > 1e-6 * np.abs(b).max()
    wrel = float(np.max(rel[mask])) if mask.any() else 0.0
    print(f"{k:12s} {float(np.max(rel)):12.3e} {wrel:12.3e} "
          f"{float(a.min()):10.3e} {float(b.min()):10.3e} {float(b.max()):10.3e}")

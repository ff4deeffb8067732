#!/usr/bin/env python
"""Separation-stack benchmark on the device.

Everything under ``separate/`` was validated on the CPU backend only; this
script executes the three headline separation paths on whatever backend JAX
resolves (the GPU; ``--platform cpu`` for the parity reference) with a
FIXED synthetic stereo mixture:

- ``multichannel``: full-rank spatial multichannel NMF EM
  (``separate_signal`` — FASST-class, reference scope
  ``pyfasst/audioModel.py:66-2422``),
- ``stereo_simm``: the two-round stereo SIMM lead/accompaniment model
  (``separate_lead_stereo`` — ``SeparateLeadStereoTF.py:1408-1620``),
- ``lead_multichannel``: the composed source-F0-filter FASST model
  (``separate_lead_multichannel`` — ``audioModel.py:2551-3418``).

Per path: cold wall (first call, includes compile), warm wall (second call,
same shapes), plus summary stats of the outputs. ``--save out.npz`` stores
the separated signals so a GPU run can be compared against a CPU run with
``--compare a.npz b.npz`` (max relative L2 difference per output).

Usage:
  python bench_separate.py [--platform cpu] [--save artifacts/sep.npz]
  python bench_separate.py --compare sep_gpu.npz sep_cpu.npz
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

SR = 16000
DUR_S = 2.0


def log(m):
    print(m, file=sys.stderr, flush=True)


def synthetic_mixture(return_components: bool = False):
    """Deterministic stereo mixture: a vibrato harmonic lead panned left
    plus a two-chord + filtered-noise accompaniment panned right.

    With ``return_components`` also returns the true stereo lead and
    accompaniment images (for ground-truth SDR)."""
    t = np.arange(int(SR * DUR_S)) / SR
    rng = np.random.default_rng(1234)
    f0 = 220.0 * (1 + 0.01 * np.sin(2 * np.pi * 5.0 * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    lead = sum((0.6 / h) * np.sin(h * phase) for h in range(1, 6))
    env = np.minimum(1.0, 10 * t) * np.minimum(1.0, 10 * (DUR_S - t))
    lead = lead * env
    chord = sum(0.3 * np.sin(2 * np.pi * f * t) for f in (130.8, 164.8, 196.0))
    noise = rng.standard_normal(len(t))
    # simple lowpass via cumulative smoothing
    k = np.hanning(65)
    noise = np.convolve(noise, k / k.sum(), mode="same")
    accomp = (chord + 0.5 * noise) * env
    left = 0.9 * lead + 0.35 * accomp
    right = 0.35 * lead + 0.9 * accomp
    x = np.stack([left, right]).astype(np.float32)
    s = 0.5 / np.abs(x).max()
    if return_components:
        lead_img = (s * np.stack([0.9 * lead, 0.35 * lead])).astype(np.float32)
        acc_img = (s * np.stack([0.35 * accomp, 0.9 * accomp])).astype(np.float32)
        return s * x, lead_img, acc_img
    return s * x


def _sdr(est: np.ndarray, ref: np.ndarray) -> float:
    ref = ref[..., : est.shape[-1]].astype(np.float64)
    est = est.astype(np.float64)
    return round(10 * np.log10(
        (ref ** 2).sum() / max(((est - ref) ** 2).sum(), 1e-30)), 2)


def run_all(save: str | None):
    import jax
    import jax.numpy as jnp

    from exemplars_vc_tpu.runtime import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()
    platform = jax.devices()[0].platform
    log(f"platform: {platform}")

    from exemplars_vc_tpu.separate import (
        separate_lead_multichannel,
        separate_lead_stereo,
        separate_signal,
    )

    x, true_lead, true_acc = synthetic_mixture(return_components=True)
    xj = jnp.asarray(x)
    results, outputs = {}, {}

    def timed(name, fn, fetch):
        t0 = time.time()
        out = fn()
        host = fetch(out)          # d2h included — that's the usable result
        cold = time.time() - t0
        t0 = time.time()
        out = fn()
        host = fetch(out)
        warm = time.time() - t0
        results[name] = {"cold_s": round(cold, 2), "warm_s": round(warm, 2),
                         "rtf_warm": round(DUR_S / warm, 2)}
        log(f"{name}: cold {cold:.2f} s, warm {warm:.2f} s")
        return host

    # --- multichannel NMF EM -------------------------------------------------
    key = jax.random.PRNGKey(0)
    imgs = timed(
        "multichannel",
        lambda: separate_signal(xj, n_sources=2, n_components=8, n_em=20,
                                n_fft=400, hop_length=80, key=key),
        lambda o: (np.asarray(o[0]), np.asarray(o[1].neg_log_like)),
    )
    images, nll = imgs
    assert np.isfinite(images).all() and np.isfinite(nll).all()
    assert nll[-1] <= nll[0], "EM must not increase NLL"
    results["multichannel"]["nll_drop"] = round(float(nll[0] - nll[-1]), 1)
    outputs["multichannel_images"] = images.astype(np.float32)

    # --- stereo SIMM lead/accompaniment -------------------------------------
    res = timed(
        "stereo_simm",
        lambda: separate_lead_stereo(xj, sample_rate=float(SR), n_fft=1024,
                                     hop_length=256, f0_min=100.0,
                                     f0_max=800.0, n_accomp=20, n_iter=15,
                                     key=jax.random.PRNGKey(1)),
        lambda o: (np.asarray(o.lead), np.asarray(o.accomp), np.asarray(o.f0)),
    )
    lead, accomp, f0 = res
    assert np.isfinite(lead).all() and np.isfinite(accomp).all()
    results["stereo_simm"]["voiced_frames"] = int((f0 > 0).sum())
    results["stereo_simm"]["f0_median_hz"] = (
        round(float(np.median(f0[f0 > 0])), 1) if (f0 > 0).any() else 0.0)
    # lead share of separated output energy — the platform-parity headline
    # (it diverged across platforms before the host-f64 spectrogram fix;
    # must agree within ±5% across platforms)
    e_lead = float((lead.astype(np.float64) ** 2).sum())
    e_acc = float((accomp.astype(np.float64) ** 2).sum())
    results["stereo_simm"]["lead_energy_share"] = round(
        e_lead / max(e_lead + e_acc, 1e-30), 4)
    results["stereo_simm"]["lead_sdr_db"] = _sdr(lead, true_lead)
    results["stereo_simm"]["accomp_sdr_db"] = _sdr(accomp, true_acc)
    outputs["stereo_simm_lead"] = lead.astype(np.float32)
    outputs["stereo_simm_accomp"] = accomp.astype(np.float32)

    # --- composed multichannel source-F0-filter ------------------------------
    res = timed(
        "lead_multichannel",
        lambda: separate_lead_multichannel(xj, sample_rate=float(SR),
                                           n_fft=1024, hop_length=256,
                                           f0_min=100.0, f0_max=800.0,
                                           n_accomp=20, n_iter_simm=10,
                                           n_em=10, key=jax.random.PRNGKey(2)),
        lambda o: (np.asarray(o.lead), np.asarray(o.accomp)),
    )
    mlead, maccomp = res
    assert np.isfinite(mlead).all() and np.isfinite(maccomp).all()
    e_lead = float((mlead.astype(np.float64) ** 2).sum())
    e_acc = float((maccomp.astype(np.float64) ** 2).sum())
    results["lead_multichannel"]["lead_energy_share"] = round(
        e_lead / max(e_lead + e_acc, 1e-30), 4)
    results["lead_multichannel"]["lead_sdr_db"] = _sdr(mlead, true_lead)
    results["lead_multichannel"]["accomp_sdr_db"] = _sdr(maccomp, true_acc)
    outputs["lead_multichannel_lead"] = mlead.astype(np.float32)
    outputs["lead_multichannel_accomp"] = maccomp.astype(np.float32)

    if save:
        os.makedirs(os.path.dirname(save) or ".", exist_ok=True)
        np.savez_compressed(save, **outputs)
        log(f"saved outputs to {save}")

    payload = {"platform": platform, "mixture_s": DUR_S, "paths": results}
    return payload


def compare(a_path: str, b_path: str):
    a, b = np.load(a_path), np.load(b_path)
    out = {}
    for k in sorted(set(a.files) & set(b.files)):
        va, vb = a[k].astype(np.float64), b[k].astype(np.float64)
        if va.shape != vb.shape:
            out[k] = {"shape_a": list(va.shape), "shape_b": list(vb.shape)}
            continue
        denom = max(np.linalg.norm(vb), 1e-12)
        out[k] = {"rel_l2": round(float(np.linalg.norm(va - vb) / denom), 6)}
    return {"compare": out}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--save", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--compare", nargs=2, default=None)
    args = ap.parse_args()

    if args.compare:
        payload = compare(*args.compare)
    else:
        if args.platform:
            os.environ["JAX_PLATFORMS"] = args.platform
            import jax

            jax.config.update("jax_platforms", args.platform)
        payload = run_all(args.save)

    s = json.dumps(payload)
    if args.out:
        with open(args.out, "w") as f:
            f.write(s + "\n")
    print(s, flush=True)


if __name__ == "__main__":
    main()

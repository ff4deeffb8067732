#!/usr/bin/env python
"""Per-iteration trajectory dump of the bench stereo-SIMM path.

Reproduces ``bench_separate.py``'s ``stereo_simm`` scenario (warmup 10 it +
round-1 15 it + melody decode + round-2 15 it) with the scan's diagnostics
channel enabled, and dumps every per-iteration scalar to an npz. Running it
once under ``JAX_PLATFORMS=cpu`` and once on the GPU, then diffing the two
npz files, pinpoints the FIRST update where the platforms diverge.

Usage:
  python tools/debug_simm.py --platform cpu --out simm_cpu.npz
  python tools/debug_simm.py --out simm_gpu.npz          # GPU
  python tools/debug_simm.py --compare simm_gpu.npz simm_cpu.npz
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(m):
    print(m, file=sys.stderr, flush=True)


def run(out_path: str, sx_from: str | None = None):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from exemplars_vc_tpu.runtime import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()
    log(f"platform: {jax.devices()[0].platform}")

    import bench_separate
    from exemplars_vc_tpu.separate.glue import host_stereo_powers
    from exemplars_vc_tpu.separate.lead import (
        _track_melody, hann_filter_basis, harmonic_dictionary,
        melody_transition)
    from exemplars_vc_tpu.separate.stereo_simm import stereo_simm

    SR, n_fft, hop = 16000.0, 1024, 256
    f0_min, f0_max, steps = 100.0, 800.0, 4
    n_accomp, n_iter, n_warmup = 20, 15, 10
    n_filters, n_filt_atoms, n_harm = 4, 20, 30

    x = bench_separate.synthetic_mixture()
    if sx_from:
        d = np.load(sx_from)
        SXR = jnp.asarray(d["SXR"], jnp.float32)
        SXL = jnp.asarray(d["SXL"], jnp.float32)
        log(f"SX loaded from {sx_from}")
    else:
        SXR, SXL = (jnp.asarray(a) for a in host_stereo_powers(x, n_fft, hop))
    F, N = SXR.shape

    n_steps = int(np.ceil(12 * steps * np.log2(f0_max / f0_min))) + 1
    f0_grid = f0_min * 2.0 ** (np.arange(n_steps) / (12.0 * steps))
    WF0 = harmonic_dictionary(f0_grid, n_fft, SR, n_harm)
    WGAMMA = hann_filter_basis(F, n_filt_atoms)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))

    dump = {"SXR_sum": np.float64(np.asarray(jnp.sum(SXR))),
            "SXL_sum": np.float64(np.asarray(jnp.sum(SXL))),
            "SXR": np.asarray(SXR, np.float32),
            "SXL": np.asarray(SXL, np.float32)}

    def record(tag, diagd):
        for k, v in diagd.items():
            dump[f"{tag}.{k}"] = np.asarray(v, np.float64)
        share = dump[f"{tag}.lead_share"]
        log(f"{tag}: lead_share per it = "
            + " ".join(f"{s:.4f}" for s in share))

    tiny_WM = jnp.full((F, n_accomp), 1e-3, jnp.float32)
    tiny_HM = jnp.full((n_accomp, N), 1e-3, jnp.float32)

    w, dw = stereo_simm(
        SXR, SXL, WF0, WGAMMA, n_filters=n_filters, n_accomp=n_accomp,
        n_iter=n_warmup, update_hgamma=True, update_accomp=False,
        WM_init=tiny_WM, HM_init=tiny_HM, key=k1, return_diagnostics=True)
    record("warm", dw)

    m1, d1 = stereo_simm(
        SXR, SXL, WF0, WGAMMA, n_filters=n_filters, n_accomp=n_accomp,
        n_iter=n_iter, update_hgamma=True, key=k1,
        HGAMMA_init=w.HGAMMA, HPHI_init=w.HPHI, HF0_init=w.HF0,
        alpha_init=w.alpha, return_diagnostics=True)
    record("r1", d1)

    log_trans = melody_transition(f0_grid, 10.0)
    path = _track_melody(m1.HF0, log_trans)
    dump["path"] = np.asarray(path, np.float64)

    WUF0 = jnp.concatenate([WF0, jnp.ones((F, 1), jnp.float32)], axis=1)
    half = 0.5 * steps
    cand = jnp.arange(n_steps, dtype=jnp.float32)
    band = (jnp.abs(cand[:, None] - path[None, :].astype(jnp.float32))
            <= half).astype(jnp.float32)
    HUF0 = jnp.concatenate(
        [m1.HF0 * band, jnp.ones((1, N), jnp.float32)], axis=0)
    m2, d2 = stereo_simm(
        SXR, SXL, WUF0, WGAMMA, n_filters=n_filters, n_accomp=n_accomp,
        n_iter=n_iter, update_hgamma=False,
        HGAMMA_init=m1.HGAMMA, HF0_init=HUF0, alpha_init=m1.alpha,
        WM_init=tiny_WM, HM_init=tiny_HM, key=k2, return_diagnostics=True)
    record("r2", d2)

    np.savez(out_path, **dump)
    log(f"saved {out_path}")


def run_oracle(out_path: str):
    """Same 3-phase pipeline, float64 numpy oracle, same inits/diagnostics."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    import bench_separate
    from exemplars_vc_tpu.separate.glue import host_stereo_powers
    from exemplars_vc_tpu.separate.lead import (
        _track_melody, hann_filter_basis, harmonic_dictionary,
        melody_transition)
    from tests.oracles.stereo_simm import stereo_simm_oracle

    SR, n_fft, hop = 16000.0, 1024, 256
    f0_min, f0_max, steps = 100.0, 800.0, 4
    n_accomp, n_iter, n_warmup = 20, 15, 10
    n_filters, n_filt_atoms, n_harm = 4, 20, 30

    x = bench_separate.synthetic_mixture()
    SXR, SXL = (np.asarray(a, np.float64)
                for a in host_stereo_powers(x, n_fft, hop))
    F, N = SXR.shape

    n_steps = int(np.ceil(12 * steps * np.log2(f0_max / f0_min))) + 1
    f0_grid = f0_min * 2.0 ** (np.arange(n_steps) / (12.0 * steps))
    WF0 = np.asarray(harmonic_dictionary(f0_grid, n_fft, SR, n_harm), np.float64)
    WGAMMA = np.asarray(hann_filter_basis(F, n_filt_atoms), np.float64)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))

    def draws(key, NF0):
        ks = jax.random.split(key, 6)
        HGAMMA = np.abs(np.asarray(
            jax.random.normal(ks[0], (n_filt_atoms, n_filters)), np.float64))
        HPHI = np.abs(np.asarray(
            jax.random.normal(ks[1], (n_filters, N)), np.float64))
        HF0 = np.abs(np.asarray(
            jax.random.normal(ks[2], (NF0, N)), np.float64))
        WM = np.abs(np.asarray(
            jax.random.normal(ks[3], (F, n_accomp)), np.float64))
        HM = np.abs(np.asarray(
            jax.random.normal(ks[4], (n_accomp, N)), np.float64))
        bR = np.asarray(jax.random.uniform(ks[5], (n_accomp,)), np.float64)
        return HGAMMA, HPHI, HF0, WM, HM, (bR, 1.0 - bR)

    dump = {"SXR_sum": np.float64(SXR.sum()), "SXL_sum": np.float64(SXL.sum())}

    def run_phase(tag, W, params, n_it, update_hgamma, update_accomp):
        diag = {k: [] for k in ("err", "alpha_r", "lead_share", "sum_hf0",
                                "sum_hphi", "sum_hgamma", "sum_hm", "sum_wm",
                                "min_hat", "max_hat", "min_lead", "max_hf0")}
        for _ in range(n_it):
            params = stereo_simm_oracle(
                SXR, SXL, W, WGAMMA, params["HGAMMA"], params["HPHI"],
                params["HF0"], params["WM"], params["HM"],
                alpha=params["alpha"], beta=params["beta"], n_iter=1,
                omega=1.0, update_hgamma=update_hgamma,
                update_accomp=update_accomp)
            params = dict(params, beta=(params["beta"][0], params["beta"][1]))
            aR, aL = params["alpha"]
            lead = (W @ params["HF0"]) * ((WGAMMA @ params["HGAMMA"]) @ params["HPHI"])
            bR, bL = params["beta"]
            hatR = np.maximum(aR**2 * lead + (params["WM"] * bR**2) @ params["HM"], 1e-20)
            hatL = np.maximum(aL**2 * lead + (params["WM"] * bL**2) @ params["HM"], 1e-20)
            diag["err"].append(params["is_error"][-1])
            diag["alpha_r"].append(aR)
            diag["lead_share"].append((aR**2 + aL**2) * lead.sum()
                                      / max(hatR.sum() + hatL.sum(), 1e-20))
            diag["sum_hf0"].append(params["HF0"].sum())
            diag["sum_hphi"].append(params["HPHI"].sum())
            diag["sum_hgamma"].append(params["HGAMMA"].sum())
            diag["sum_hm"].append(params["HM"].sum())
            diag["sum_wm"].append(params["WM"].sum())
            diag["min_hat"].append(min(hatR.min(), hatL.min()))
            diag["max_hat"].append(max(hatR.max(), hatL.max()))
            diag["min_lead"].append(lead.min())
            diag["max_hf0"].append(params["HF0"].max())
        for k, v in diag.items():
            dump[f"{tag}.{k}"] = np.asarray(v, np.float64)
        log(f"{tag}: lead_share per it = "
            + " ".join(f"{s:.4f}" for s in diag["lead_share"]))
        return params

    HGAMMA, HPHI, HF0, WM, HM, beta = draws(k1, WF0.shape[1])
    tiny_WM = np.full((F, n_accomp), 1e-3)
    tiny_HM = np.full((n_accomp, N), 1e-3)
    p = dict(HGAMMA=HGAMMA, HPHI=HPHI, HF0=HF0, WM=tiny_WM, HM=tiny_HM,
             alpha=(0.5, 0.5), beta=beta)
    p = run_phase("warm", WF0, p, n_warmup, True, False)
    # r1: fresh WM/HM/beta from the SAME k1 draws (stereo_simm re-draws)
    p1 = dict(HGAMMA=p["HGAMMA"], HPHI=p["HPHI"], HF0=p["HF0"], WM=WM, HM=HM,
              alpha=tuple(p["alpha"]), beta=beta)
    p1 = run_phase("r1", WF0, p1, n_iter, True, True)

    path = np.asarray(_track_melody(
        jnp.asarray(p1["HF0"], jnp.float32),
        melody_transition(f0_grid, 10.0)))
    dump["path"] = np.asarray(path, np.float64)

    WUF0 = np.concatenate([WF0, np.ones((F, 1))], axis=1)
    half = 0.5 * steps
    cand = np.arange(n_steps, dtype=np.float64)
    band = (np.abs(cand[:, None] - path[None, :]) <= half).astype(np.float64)
    HUF0 = np.concatenate([p1["HF0"] * band, np.ones((1, N))], axis=0)
    _, HPHI2, _, WM2, HM2, beta2 = draws(k2, WUF0.shape[1])
    p2 = dict(HGAMMA=p1["HGAMMA"], HPHI=HPHI2, HF0=HUF0, WM=tiny_WM,
              HM=tiny_HM, alpha=tuple(p1["alpha"]), beta=beta2)
    p2 = run_phase("r2", WUF0, p2, n_iter, False, True)

    np.savez(out_path, **dump)
    log(f"saved {out_path}")


def compare(a_path: str, b_path: str):
    import numpy as np

    a, b = np.load(a_path), np.load(b_path)
    for k in sorted(set(a.files) & set(b.files)):
        va, vb = np.atleast_1d(a[k]), np.atleast_1d(b[k])
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.abs(va - vb) / np.maximum(np.abs(vb), 1e-12)
        worst = float(np.max(rel))
        first_bad = int(np.argmax(rel > 0.05)) if (rel > 0.05).any() else -1
        print(f"{k:24s} max_rel={worst:10.3e} first_it>5%={first_bad}")
        if worst > 0.05 and va.size <= 16:
            print(f"  a: {np.array2string(va, precision=4)}")
            print(f"  b: {np.array2string(vb, precision=4)}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--out", default="/tmp/simm_traj.npz")
    ap.add_argument("--compare", nargs=2, default=None)
    ap.add_argument("--oracle", action="store_true")
    ap.add_argument("--sx-from", default=None)
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    if args.oracle:
        run_oracle(args.out)
        return
    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
        import jax

        jax.config.update("jax_platforms", args.platform)
    run(args.out, sx_from=args.sx_from)


if __name__ == "__main__":
    main()

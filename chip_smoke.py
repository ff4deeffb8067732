#!/usr/bin/env python
"""Smoke test of the conversion pipeline on one GPU, end to end, in one process.

    python chip_smoke.py               # the one-card phases below
    python chip_smoke.py --chips 4     # only the four-card phase

Phases (one card):

- ``device``: the card's name and power limit, JAX's devices and version,
  the compilation cache directory;
- ``convert``: a seeded parallel corpus (``io.synth_corpus``), then the CLI's
  ``make-dict`` and ``convert`` of the held-out source at the shipped
  defaults (8 pairs, STFT 400/80, MU 150 iterations at tol 1e-4,
  Griffin-Lim 300 from the source phase); checks the wav, its length and
  that MCD against the true target beats the no-conversion anchor;
- ``reference``: the card against plain float64 numpy at real widths — the
  MU solve of the ``convert`` phase, rfft/irfft/stft/istft at n_fft 400,
  1024 and 2048, and the DTW paths of the 8 pairs;
- ``large_dict``: the 14-warp VTLP dictionary (K = 15 × the ``convert``
  phase's K) through the same CLI, with the solve's memory analysis;
- ``world``: one CLI conversion on the WORLD vocoder path.

``--chips 4`` runs the multi-device dry run of ``__graft_entry__`` on four
cards and the ``convert`` phase's conversion with ``nmf.solver=mu_sharded``
against the single-card ``mu`` result, and nothing else.

Findings go to stdout line by line; the last line is one JSON object,
``{"ok": true, "device": {...}}``. Without a GPU, or when any check fails,
the script exits nonzero and prints no such line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "corpus")        # listed in .gitignore
VTLP_WARPS = "0.86,0.88,0.9,0.92,0.94,0.96,0.98,1.02,1.04,1.06,1.08,1.1,1.12,1.14"
MU_RTOL = 1e-4          # GPU MU against float64 numpy MU
FFT_RTOL = 1e-5         # GPU FFT/STFT/ISTFT against float64 numpy
SHARDED_RTOL = 1e-3     # mu_sharded conversion against single-card mu


def say(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rel_max_err(got, ref) -> float:
    """max |got − ref| / max |ref|."""
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def timed(fn, *args, reps: int = 5) -> tuple[float, list[float]]:
    """Median wall seconds of fn(*args) after one warm-up call, each call
    ending in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def cli(argv: list[str]) -> dict:
    """Run the CLI in this process; return the JSON line it prints."""
    from exemplars_vc_tpu.pipelines.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    say(f"  cli {argv[0]}: {json.dumps(out)}")
    return out


class Ctx:
    """What the phases share: corpus paths, the dictionary store, sizes."""

    def __init__(self, tmp: str):
        from exemplars_vc_tpu.io.synth_corpus import write_corpus
        from exemplars_vc_tpu.pipelines.evaluate import heldout_pair

        t0 = time.perf_counter()
        self.data = write_corpus(os.path.join(WORK, "seed0"), seed=0)
        self.src_wav, self.tar_wav = heldout_pair(self.data)
        say(f"  corpus {self.data} ready in {time.perf_counter() - t0:.3f} s")
        self.tmp = tmp
        self.store = os.path.join(tmp, "store")
        self.k_pad = None

    def common(self, store: str | None = None) -> list[str]:
        return ["--data", self.data, "--store", store or self.store,
                "--nb-file", "8"]

    def convert_args(self, out: str, *overrides: str, store=None) -> list[str]:
        args = ["convert", *self.common(store), "--wav", self.src_wav,
                "--out", out, "--ref-wav", self.tar_wav]
        for o in overrides:
            args += ["-o", o]
        return args


# --------------------------------------------------------------------- phases

def phase_device() -> dict:
    import jax

    from exemplars_vc_tpu.runtime import (
        enable_persistent_compilation_cache,
        gpu_name_and_power_limit,
    )

    smi = gpu_name_and_power_limit()
    check(smi is not None, "nvidia-smi gives the card's name and power limit")
    for line in smi.splitlines():
        say(line)
    say(f"  jax {jax.__version__}, devices {jax.devices()}")
    say(f"  compilation cache: {enable_persistent_compilation_cache()}")
    return {"nvidia_smi": smi, "jax": jax.__version__}


def phase_convert(ctx: Ctx) -> dict:
    from exemplars_vc_tpu.config import load_config
    from exemplars_vc_tpu.io import read_wav
    from exemplars_vc_tpu.pipelines.convert import mcd_between_signals

    out_wav = os.path.join(ctx.tmp, "converted.wav")
    t0 = time.perf_counter()
    md = cli(["make-dict", *ctx.common()])
    t_dict = time.perf_counter() - t0
    cv = cli(ctx.convert_args(out_wav))
    cold = time.perf_counter() - t0
    ctx.k_pad = ((md["total_exemplars"] + 511) // 512) * 512

    # one warm repeat: a fresh store, so the dictionary is built again
    t0 = time.perf_counter()
    warm_store = os.path.join(ctx.tmp, "store_warm")
    cli(["make-dict", *ctx.common(warm_store)])
    warm = cli(ctx.convert_args(out_wav, store=warm_store))
    t_warm = time.perf_counter() - t0

    x_in, sr = read_wav(ctx.src_wav)
    y, sr_out = read_wav(out_wav)
    tar, _ = read_wav(ctx.tar_wav)
    anchor = mcd_between_signals(x_in, tar, load_config())
    mcd = cv["mcd_vs_reference"]
    check(sr_out == sr and np.isfinite(y).all(), "converted wav is finite")
    check(abs(len(y) - len(x_in)) <= 80, f"length {len(y)} vs {len(x_in)}")
    check(np.isfinite(mcd) and mcd < anchor,
          f"MCD {mcd} dB finite and below the no-conversion anchor {anchor} dB")
    say(f"  K = {ctx.k_pad} exemplars ({md['total_exemplars']} aligned), "
        f"F = {1 + len(x_in) // 80} frames, D = 201")
    say(f"  cold (compile + run) {cold:.3f} s, of which make-dict "
        f"{t_dict:.3f} s; warm repeat {t_warm:.3f} s")
    say(f"  timings cold {cv['timings']} warm {warm['timings']}")
    say(f"  MCD vs true target {mcd:.3f} dB, no-conversion anchor {anchor:.3f} dB")
    return {"k": ctx.k_pad, "cold_s": cold, "make_dict_cold_s": t_dict,
            "warm_s": t_warm, "timings_cold": cv["timings"],
            "timings_warm": warm["timings"], "mcd_db": mcd,
            "anchor_mcd_db": anchor}


def _mu_reference(X, A, n_iter: int):
    """Frobenius MU in float64 numpy: sklearn's update_H=False init, the
    same update and the same zero-denominator guard as factorize.nmf."""
    from exemplars_vc_tpu.factorize.nmf import _EPS

    K = A.shape[0]
    H = np.full((X.shape[0], K), np.sqrt(max(X.mean(), 0.0) / K))
    num = X @ A.T
    for _ in range(n_iter):
        den = (H @ A) @ A.T
        den[den == 0.0] = _EPS
        H *= num / den
    return H, float(np.linalg.norm(X - H @ A))


def _np_stft(x, n_fft, hop):
    w = np.hanning(n_fft + 1)[:-1]
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(n_fft // 2, n_fft // 2)],
                mode="reflect")
    n = (xp.shape[-1] - n_fft) // hop + 1
    idx = np.arange(n)[:, None] * hop + np.arange(n_fft)[None, :]
    return np.fft.rfft(xp[..., idx] * w, axis=-1)


def _np_istft(S, n_fft, hop, length):
    w = np.hanning(n_fft + 1)[:-1]
    frames = np.fft.irfft(S, n=n_fft, axis=-1) * w
    out_len = n_fft + hop * (S.shape[0] - 1)
    y, wsum = np.zeros(out_len), np.zeros(out_len)
    for f in range(S.shape[0]):
        y[f * hop: f * hop + n_fft] += frames[f]
        wsum[f * hop: f * hop + n_fft] += w * w
    y = (y / np.maximum(wsum, 1e-8))[n_fft // 2: out_len - n_fft // 2]
    return np.pad(y, (0, max(0, length - len(y))))[:length]


def _dtw_reference(a, b):
    """Classic DTW in float64 numpy, swept by anti-diagonals:
    D[i,j] = C[i,j] + min(D[i-1,j-1], D[i-1,j], D[i,j-1]), traceback
    preferring the diagonal, then up, then left on ties."""
    C = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    ta, tb = C.shape
    D = np.full((ta + 1, tb + 1), np.inf)       # row/col 0 are the borders
    D[1, 1] = C[0, 0]
    for d in range(1, ta + tb - 1):
        i = np.arange(max(0, d - tb + 1), min(ta, d + 1))
        j = d - i
        best = np.minimum(np.minimum(D[i, j], D[i, j + 1]), D[i + 1, j])
        D[i + 1, j + 1] = C[i, j] + best
    i, j = ta - 1, tb - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        cands = [(D[i, j], i - 1, j - 1), (D[i, j + 1], i - 1, j),
                 (D[i + 1, j], i, j - 1)]
        _, i, j = min(cands, key=lambda c: c[0])   # first wins on ties
        path.append((i, j))
    return np.asarray(path[::-1]).T


def phase_reference(ctx: Ctx) -> dict:
    import jax
    import jax.numpy as jnp

    from exemplars_vc_tpu.align.dtw import _dtw_cost_dirs, dtw_batch, pairwise_sqdist
    from exemplars_vc_tpu.config import load_config
    from exemplars_vc_tpu.dsp import istft, stft
    from exemplars_vc_tpu.dsp import fft as F
    from exemplars_vc_tpu.factorize import nmf_activations
    from exemplars_vc_tpu.io import ArtifactStore, read_wav
    from exemplars_vc_tpu.pipelines.conv_dicts import extract_stft_features
    from exemplars_vc_tpu.pipelines.convert import _aligned_dicts
    from exemplars_vc_tpu.pipelines.make_dict import make_dictionary

    out = {}
    cfg = load_config()
    store = ArtifactStore(ctx.store)

    # -- NMF MU at the convert phase's K, F, D, 150 iterations, tol 0
    x, _ = read_wav(ctx.src_wav)
    X = extract_stft_features(x, cfg)
    A = _aligned_dicts(cfg, store, ctx.data, 8)[0]["stft"][0]
    st = nmf_activations(X, A, tol=0.0, max_iter=150)
    H_ref, err_ref = _mu_reference(np.asarray(X, np.float64),
                                   np.asarray(A, np.float64), 150)
    e_h = rel_max_err(st.H, H_ref)
    e_err = abs(float(st.error) - err_ref) / err_ref
    say(f"  NMF MU (K={A.shape[0]}, F={X.shape[0]}, D={X.shape[1]}, 150 it, "
        f"precision highest) vs float64 numpy: rel max err H {e_h:.3e}, "
        f"|X-HA| {e_err:.3e} (tolerance {MU_RTOL:g}, max|dH|/max|H|)")
    check(e_h <= MU_RTOL and e_err <= MU_RTOL, "GPU MU matches float64 MU")
    solve = lambda X, A: nmf_activations(X, A, tol=1e-4, max_iter=150)
    t_solve, ts = timed(solve, X, A)
    t_150 = timed(lambda X, A: nmf_activations(X, A, tol=0.0, max_iter=150),
                  X, A)[0]
    it = int(solve(X, A).n_iter)
    say(f"  MU solve, shipped defaults (tol 1e-4, stopped at {it} it): "
        f"median {t_solve:.6f} s of {[round(t, 6) for t in ts]}; "
        f"150 it at tol 0: {t_150:.6f} s")
    out["nmf"] = {"k": int(A.shape[0]), "f": int(X.shape[0]), "rel_err_h": e_h,
                  "rel_err_residual": e_err, "solve_s": t_solve,
                  "solve_iters": it, "solve_150it_s": t_150}

    # -- FFT / STFT / ISTFT at the pipeline's sizes
    rng = np.random.default_rng(0)
    fft_errs = {}
    for n, hop in ((400, 80), (1024, 256), (2048, 512)):
        xr = rng.standard_normal((8 * 128, n))
        Xc = _np_stft(rng.standard_normal(3 * n), n, hop)
        sig = rng.standard_normal((8, 56000))
        one = sig[0]
        S1 = _np_stft(one, n, hop)
        errs = {
            "rfft": rel_max_err(F.rfft(jnp.asarray(xr, jnp.float32)),
                                np.fft.rfft(xr, axis=-1)),
            "irfft": rel_max_err(F.irfft(jnp.asarray(Xc, jnp.complex64), n=n),
                                 np.fft.irfft(Xc, n=n, axis=-1)),
            "stft": rel_max_err(stft(jnp.asarray(sig, jnp.float32), n_fft=n,
                                     hop_length=hop), _np_stft(sig, n, hop)),
            "istft": rel_max_err(istft(jnp.asarray(S1, jnp.complex64), n_fft=n,
                                       hop_length=hop, length=len(one)),
                                 _np_istft(S1, n, hop, len(one))),
        }
        say(f"  n_fft {n}: float32 XLA FFT rel max err vs float64 numpy "
            f"{ {k: f'{v:.2e}' for k, v in errs.items()} } "
            f"(tolerance {FFT_RTOL:g})")
        check(max(errs.values()) <= FFT_RTOL, f"FFT layer at n_fft {n}")
        fft_errs[n] = errs
    out["fft_rel_err"] = fft_errs

    # -- DTW paths over the 8 dictionary pairs against classic float64 DTW
    art = make_dictionary(cfg, store, ctx.data, nb_file=8)
    fa, fb = jnp.asarray(art.feat_a), jnp.asarray(art.feat_b)
    la, lb = jnp.asarray(art.len_a), jnp.asarray(art.len_b)
    res = dtw_batch(fa, fb, la, lb)
    pi, pj, pl = (np.asarray(a) for a in (res.path_i, res.path_j, res.path_len))
    fa_h, fb_h = np.asarray(fa, np.float64), np.asarray(fb, np.float64)
    same = 0
    for n in range(fa_h.shape[0]):
        ref = _dtw_reference(fa_h[n, : int(art.len_a[n])],
                             fb_h[n, : int(art.len_b[n])])
        got = np.stack([pi[n, : pl[n]], pj[n, : pl[n]]])
        same += int(got.shape == ref.shape and (got == ref).all())
    say(f"  DTW (float32 cost, precision highest): {same}/{fa_h.shape[0]} "
        f"paths identical to classic float64 DTW (tolerance: none)")
    check(same == fa_h.shape[0], "DTW paths identical")
    t_dtw = timed(dtw_batch, fa, fb, la, lb)[0]
    dp = jax.jit(jax.vmap(lambda a, b, m, n: _dtw_cost_dirs(
        pairwise_sqdist(a, b), m, n)[0]))
    t_dp = timed(dp, fa, fb, la, lb)[0]
    steps = int(-(-int(np.max(np.asarray(la) + np.asarray(lb) - 1)) // 128) * 128)
    say(f"  DTW batch {tuple(fa.shape)} vs {tuple(fb.shape)}: dtw_batch "
        f"{t_dtw:.6f} s; cost matrix + wavefront DP {t_dp:.6f} s over "
        f"{steps} anti-diagonal steps = {t_dp / steps * 1e6:.3f} us per step")
    out["dtw"] = {"pairs_identical": same, "dtw_batch_s": t_dtw,
                  "dp_s": t_dp, "steps": steps, "s_per_step": t_dp / steps}
    return out


def phase_large_dict(ctx: Ctx) -> dict:
    import jax

    from exemplars_vc_tpu.config import load_config
    from exemplars_vc_tpu.factorize import nmf_activations
    from exemplars_vc_tpu.io import ArtifactStore, read_wav
    from exemplars_vc_tpu.pipelines.conv_dicts import extract_stft_features
    from exemplars_vc_tpu.pipelines.convert import _aligned_dicts

    out_wav = os.path.join(ctx.tmp, "converted_large.wav")
    ov = f"data.dict_augment_warps={VTLP_WARPS}"
    t0 = time.perf_counter()
    cv = cli(ctx.convert_args(out_wav, ov))
    wall = time.perf_counter() - t0
    y, _ = read_wav(out_wav)
    check(np.isfinite(y).all() and np.isfinite(cv["mcd_vs_reference"]),
          "large-dictionary conversion is finite")

    cfg = load_config(overrides=[ov])
    A = _aligned_dicts(cfg, ArtifactStore(ctx.store), ctx.data, 8)[0]["stft"][0]
    X = extract_stft_features(read_wav(ctx.src_wav)[0], cfg)
    K = int(A.shape[0])
    copies = 1 + len(VTLP_WARPS.split(","))
    check(ctx.k_pad is None or K == copies * ctx.k_pad,
          f"K {K} = {copies} x {ctx.k_pad}")
    solve = jax.jit(lambda X, A: nmf_activations(X, A, tol=1e-4, max_iter=150))
    compiled = solve.lower(X, A).compile()
    t_solve, ts = timed(compiled, X, A, reps=3)
    say(f"  K = {K}: A {A.size * 4 / 1e6:.1f} MB, H {X.shape[0] * K * 4 / 1e6:.1f} MB "
        f"(float32); conversion incl. compile {wall:.3f} s, "
        f"timings {cv['timings']}, MCD {cv['mcd_vs_reference']:.3f} dB")
    say(f"  MU solve at K = {K}: median {t_solve:.6f} s of "
        f"{[round(t, 6) for t in ts]}")
    say(f"  solve memory_analysis: {compiled.memory_analysis()}")
    return {"k": K, "a_bytes": int(A.size * 4), "h_bytes": int(X.shape[0] * K * 4),
            "convert_cold_s": wall, "timings": cv["timings"],
            "mcd_db": cv["mcd_vs_reference"], "solve_s": t_solve}


def phase_world(ctx: Ctx) -> dict:
    from exemplars_vc_tpu.io import read_wav

    out_wav = os.path.join(ctx.tmp, "converted_world.wav")
    t0 = time.perf_counter()
    cold = cli(ctx.convert_args(out_wav, "data.use_stft=false"))
    t_cold = time.perf_counter() - t0
    warm_store = os.path.join(ctx.tmp, "store_world")
    cli(["make-dict", *ctx.common(warm_store)])
    t0 = time.perf_counter()
    warm = cli(ctx.convert_args(out_wav, "data.use_stft=false", store=warm_store))
    t_warm = time.perf_counter() - t0
    y, _ = read_wav(out_wav)
    check(y.size > 0 and np.isfinite(y).all(), "WORLD conversion is finite")
    say(f"  WORLD path: compile + run {t_cold:.3f} s, run {t_warm:.3f} s "
        f"(conversion dictionaries rebuilt), timings {warm['timings']}, "
        f"MCD {warm['mcd_vs_reference']:.3f} dB")
    return {"cold_s": t_cold, "warm_s": t_warm, "timings": warm["timings"],
            "mcd_db": warm["mcd_vs_reference"]}


def phase_four_cards(ctx: Ctx) -> dict:
    import jax
    from dataclasses import replace

    from __graft_entry__ import dryrun_multichip

    from exemplars_vc_tpu.config import load_config
    from exemplars_vc_tpu.io import ArtifactStore, read_wav
    from exemplars_vc_tpu.parallel import make_mesh, sharded_nmf_activations
    from exemplars_vc_tpu.pipelines.conv_dicts import extract_stft_features
    from exemplars_vc_tpu.pipelines.convert import _aligned_dicts, convert_utterance

    n = len(jax.devices())
    check(n == 4, f"four devices, found {n}")
    t0 = time.perf_counter()
    dryrun_multichip(4)
    say(f"  dryrun_multichip(4): six shardings equal their single-device "
        f"twins ({time.perf_counter() - t0:.3f} s)")

    cfg_mu = load_config(overrides=["misc.nb_file=8"])
    cfg_sh = replace(cfg_mu, nmf=replace(cfg_mu.nmf, solver="mu_sharded"))
    res = {}
    for name, cfg in (("mu", cfg_mu), ("mu_sharded", cfg_sh)):
        store = ArtifactStore(os.path.join(ctx.tmp, f"store_{name}"))
        t0 = time.perf_counter()
        res[name] = convert_utterance(cfg, store, ctx.data, ctx.src_wav,
                                      nb_file=8, reference_wav=ctx.tar_wav)
        say(f"  {name}: {time.perf_counter() - t0:.3f} s incl. compile, "
            f"{res[name].n_iter} MU iterations, MCD "
            f"{res[name].mcd_vs_reference:.3f} dB")
    Y_mu = np.asarray(res["mu"].converted["stft"], np.float64)
    Y_sh = np.asarray(res["mu_sharded"].converted["stft"], np.float64)
    dY = rel_max_err(Y_sh, Y_mu)
    say(f"  mu_sharded over 4 cards vs single-card mu: rel max err of the "
        f"converted magnitude {dY:.3e} (tolerance {SHARDED_RTOL:g})")
    check(np.isfinite(res["mu_sharded"].audio).all(), "sharded audio finite")
    check(dY <= SHARDED_RTOL, "sharded conversion matches single-card")

    # the dictionary really spreads over the four cards
    A = _aligned_dicts(cfg_mu, ArtifactStore(os.path.join(ctx.tmp, "store_mu")),
                       ctx.data, 8)[0]["stft"][0]
    X = extract_stft_features(read_wav(ctx.src_wav)[0], cfg_mu)
    st = sharded_nmf_activations(X, A, make_mesh(data=1, dict_=4))
    placed = {s.device for s in st.H.addressable_shards}
    say(f"  sharded H {tuple(st.H.shape)}: shards on {sorted(d.id for d in placed)}")
    check(placed == set(jax.devices()), "one H shard on each card")
    return {"dryrun": "ok", "rel_err_y": dY,
            "iters": {k: int(v.n_iter) for k, v in res.items()}}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    ap.add_argument("--phases", default="convert,reference,large_dict,world",
                    help="comma list of one-card phases to run after 'device'")
    ap.add_argument("--out", default=None, help="also write the findings as JSON")
    return ap.parse_args(argv)


def select_phases(args: argparse.Namespace) -> list[str]:
    """The phases after ``device``: ``--chips 4`` runs its own and no other."""
    return ["four_cards"] if args.chips == 4 else args.phases.split(",")


def main(argv=None) -> int:
    args = parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX's default platform is {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    phases = select_phases(args)
    findings = {"device": phase_device()}
    os.makedirs(WORK, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=WORK) as tmp:
        ctx = Ctx(tmp)
        for name in phases:
            say(f"[{name}]")
            t0 = time.perf_counter()
            findings[name] = globals()[f"phase_{name}"](ctx)
            say(f"[{name}] ok in {time.perf_counter() - t0:.3f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(findings, f, indent=1, default=str)
    say(json.dumps({"ok": True, "device": {"platform": devs[0].platform,
                                           "kind": devs[0].device_kind,
                                           "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Stage 04/05 — exemplar conversion of an utterance.

Re-design of the reference's conversion workhorse ``04_align_n_nmf.py``
(entry ``:434-470``) and the minimal demo ``05_conversion.py:84-108``:

1. gather the aligned exemplar dictionaries A (source) / B (target) along the
   DTW paths (replaces the python loops of ``align_sp_ap_f0``,
   ``04_align_n_nmf.py:100-169``),
2. decompose the input utterance over A with fixed-dictionary NMF
   (``:194-215``), optionally with residual compensation (``:292-299``),
3. convert Y = (H·B)⊙R (``:336-393``), and
4. resynthesize — Griffin-Lim for the STFT path (``:182-191``) or the WORLD
   vocoder for sp/ap/f0 (``:172-179``).

Everything from features to the converted magnitude runs jitted on device;
H/R are memoized in the artifact store exactly like the reference's
``H_test_*`` / ``R_test_*`` pickles (``:251-302``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from exemplars_vc_tpu.align.exemplar import build_exemplar_dicts_padded
from exemplars_vc_tpu.config import Config
from exemplars_vc_tpu.dsp import griffin_lim
from exemplars_vc_tpu.factorize import (
    convert_features,
    nmf_activations,
    nnls_activations,
    qr_activations,
    residual_compensation,
)
from exemplars_vc_tpu.factorize.nmf import NmfState
from exemplars_vc_tpu.io import ArtifactStore, read_wav, write_wav
from exemplars_vc_tpu.obs import Timer, get_logger
from exemplars_vc_tpu.pipelines.conv_dicts import (
    build_conversion_dicts,
    build_conversion_dicts_pair,
)
from exemplars_vc_tpu.pipelines.make_dict import make_dictionary

# full float32 matmuls on the conversion path (a GPU may otherwise use TF32)
_HIGHEST = jax.lax.Precision.HIGHEST


@dataclass
class ConversionResult:
    audio: np.ndarray
    sr: int
    # converted feature matrices stay device-resident (np.asarray on demand —
    # eagerly converting would serialize a multi-MB d2h into every conversion)
    converted: dict[str, np.ndarray]
    n_iter: int
    nmf_error: float
    timings: dict[str, float] = field(default_factory=dict)
    mcd_vs_reference: float | None = None


def mcd_between_signals(a: np.ndarray, b: np.ndarray, cfg: Config) -> float:
    """DTW-aligned mel-cepstral distortion (dB) between two waveforms — the
    BASELINE quality metric (the reference itself has no objective metric;
    its eval is listening to ``wav/`` outputs, SURVEY §4)."""
    from exemplars_vc_tpu.dsp import mcep
    from exemplars_vc_tpu.obs import mcd_aligned

    m = cfg.mcep
    ca = mcep(jnp.asarray(a, jnp.float32), frame_length=m.frame_length,
              hop_length=m.hop_length, order=m.order, alpha=m.alpha)
    cb = mcep(jnp.asarray(b, jnp.float32), frame_length=m.frame_length,
              hop_length=m.hop_length, order=m.order, alpha=m.alpha)
    return float(mcd_aligned(ca, cb))


def _stack_context(M: jnp.ndarray, c: int) -> jnp.ndarray:
    """(N, D) → (N, D·(2c+1)): edge-clamped ±c neighbor rows concatenated
    along the feature axis — multi-frame exemplars. Row n of the output is
    [M[n−c]; …; M[n]; …; M[n+c]], so activations must explain a whole local
    trajectory, not one frame (measured −0.3…−0.5 dB MCD on top of the KL
    win; measured on the real corpus). Exemplar rows are ordered along
    the concatenated DTW paths, so neighbors are temporally adjacent source
    frames except at the ~2c rows per utterance boundary."""
    if c <= 0:
        return M
    N = M.shape[0]
    base = jnp.arange(N)
    return jnp.concatenate(
        [M[jnp.clip(base + s, 0, N - 1)] for s in range(-c, c + 1)], axis=1)


def _solve_mel_matrix(d_feat: int, cfg: Config) -> jnp.ndarray:
    """Mel filterbank for the activation solve — the STFT grid is inferred
    from the feature bin count (conversion H·B stays full-resolution; only
    the activation estimate moves to mel)."""
    from exemplars_vc_tpu.dsp import mel_filterbank

    return jnp.asarray(mel_filterbank(cfg.data.sr, 2 * (d_feat - 1),
                                      n_mels=cfg.nmf.solve_mels))


def _preprocess_frames(X: jnp.ndarray, cfg: Config) -> jnp.ndarray:
    """The per-frame input preprocessing :func:`_solve_activations` applies
    to X: mel projection (``nmf.solve_domain='mel'``) then context stacking
    (``nmf.context_frames``). Exposed so ``serve.convert_batch`` can run it
    PER UTTERANCE before concatenating frames — both steps only look at a
    frame and its ±c neighbors, so per-utterance preprocessing keeps the
    concatenated batch solve exactly equal to per-utterance conversion (no
    mel/context mixing across utterance boundaries)."""
    if cfg.nmf.solve_domain == "mel" and X.shape[1] > cfg.nmf.solve_mels:
        X = jnp.dot(X, _solve_mel_matrix(X.shape[1], cfg).T, precision=_HIGHEST)
    return _stack_context(X, cfg.nmf.context_frames)


def _smooth_h(H: jnp.ndarray, s: int) -> jnp.ndarray:
    """Edge-clamped box filter along time — smooths frame-to-frame exemplar
    switching before the conversion matmul (``nmf.h_smooth``)."""
    if s <= 0:
        return H
    F = H.shape[0]
    base = jnp.arange(F)
    return sum(H[jnp.clip(base + d, 0, F - 1)]
               for d in range(-s, s + 1)) / (2 * s + 1)


def _solve_activations(X: jnp.ndarray, A: jnp.ndarray, cfg: Config,
                       x_preprocessed: bool = False) -> NmfState:
    """Dispatch to the configured activation solver.

    nmf.solver: 'mu' (sklearn-parity multiplicative updates; 'auto'),
    'mu_sharded' (the same Frobenius update with the dictionary sharded over
    every device), 'cd'/'nnls' (FISTA NNLS at the reference cd budget of 200
    iters), 'qr' (unconstrained least squares — the reference's unfinished
    QRMF variant, 04_align_n_qrmf.py).

    nmf.context_frames > 0 stacks neighbor frames onto BOTH X and A before
    the solve; H keeps its (frames × K) shape, so conversion (H·B) is
    untouched downstream. ``x_preprocessed=True`` means the caller already
    ran :func:`_preprocess_frames` on X (e.g. per utterance, so a
    concatenated batch does not mix mel/context across utterance boundaries
    — ``serve.convert_batch``); A still gets the full preprocessing here,
    gated on A's ORIGINAL feature width (A and X always share it).

    Post-solve refinements (both beyond the reference's dense solver, both
    shape-preserving so conversion/residual/serving are untouched):
    ``nmf.prune_topk`` re-solves each frame over only its top-k exemplars
    (hard per-frame sparsity); ``nmf.activation_power`` sharpens H with a
    per-frame gain refit."""
    c = cfg.nmf.context_frames
    if cfg.nmf.solve_domain == "mel" and A.shape[1] > cfg.nmf.solve_mels:
        M = _solve_mel_matrix(A.shape[1], cfg)
        if not x_preprocessed:
            X = jnp.dot(X, M.T, precision=_HIGHEST)
        A = jnp.dot(A, M.T, precision=_HIGHEST)
    if c > 0:
        if not x_preprocessed:
            X = _stack_context(X, c)
        A = _stack_context(A, c)
    if cfg.nmf.normalize_exemplars:
        # solve on unit-L2 atoms, return H in the unnormalized basis:
        # X ≈ H'·(A/s) = (H'/s)·A, so H = H'/s and everything downstream
        # (conversion H·B, residual, prune/sharpen refits on the original A)
        # is untouched. Zero padding rows stay exactly zero in A/s and
        # collapse their H column to 0 in the first MU step (numerator 0).
        s = jnp.sqrt(jnp.sum(A * A, axis=1))          # (K,)
        s = jnp.maximum(s, 1e-12)
        st = _dispatch_solver(X, A / s[:, None], cfg)
        st = NmfState(st.H / s[None, :], st.n_iter, st.error)
    else:
        st = _dispatch_solver(X, A, cfg)
    if cfg.nmf.prune_topk > 0:
        from exemplars_vc_tpu.factorize import prune_topk_refine

        beta = cfg.nmf.beta_loss if cfg.nmf.solver in ("auto", "mu") \
            else "frobenius"
        st = prune_topk_refine(X, A, st.H, k=cfg.nmf.prune_topk,
                               beta_loss=beta, n_iter=cfg.nmf.prune_iters)
    if cfg.nmf.activation_power != 1.0:
        from exemplars_vc_tpu.factorize import sharpen_activations

        H = sharpen_activations(st.H, A, X, cfg.nmf.activation_power)
        # error is the pre-sharpening solver error; the refit gain keeps the
        # reconstruction comparable, and recomputing would add a matmul
        st = NmfState(H, st.n_iter, st.error)
    if cfg.nmf.h_smooth > 0:
        st = NmfState(_smooth_h(st.H, cfg.nmf.h_smooth), st.n_iter, st.error)
    return st


def _dispatch_solver(X: jnp.ndarray, A: jnp.ndarray, cfg: Config) -> NmfState:
    solver = cfg.nmf.solver
    if solver in ("auto", "mu"):
        work = None if cfg.nmf.work_dtype == "float32" else jnp.dtype(cfg.nmf.work_dtype)
        return nmf_activations(X, A, beta_loss=cfg.nmf.beta_loss,
                               tol=cfg.nmf.tol, max_iter=cfg.nmf.max_iter,
                               work_dtype=work, l1=cfg.nmf.sparsity_l1)
    if solver == "mu_sharded":
        # production multi-device composition: the exemplar dictionary (and
        # H) sharded over every available device's `dict` mesh axis, one
        # (F, D) psum per MU iteration (parallel/sharded_nmf.py). H stays
        # device-sharded; downstream conversion/residual matmuls run under
        # the same sharding (XLA inserts the collectives). Frobenius only —
        # the sharded solver implements the Frobenius MU update.
        from exemplars_vc_tpu.parallel import make_mesh, sharded_nmf_activations

        n = len(jax.devices())
        while A.shape[0] % n:     # shard count must divide K (K is padded to
            n -= 1                # a 512 multiple, so this is for tiny dicts)
        mesh = make_mesh(data=1, dict_=n)
        return sharded_nmf_activations(X, A, mesh, tol=cfg.nmf.tol,
                                       max_iter=cfg.nmf.max_iter)
    if solver in ("cd", "nnls"):
        # one sklearn-cd "iteration" is a full K-coordinate sweep; matching
        # its objective takes ~10× as many FISTA steps (each two matmuls —
        # see config.NmfConfig.nnls_iters and PARITY.md C12)
        n_iter = cfg.nmf.nnls_iters or 10 * max(cfg.nmf.max_iter, 20)
        H = nnls_activations(X, A, n_iter=n_iter)
        err = jnp.linalg.norm(X - jnp.dot(H, A, precision=_HIGHEST))
        return NmfState(H, jnp.int32(n_iter), err)
    if solver in ("qr", "qrmf"):
        H = jnp.maximum(qr_activations(X, A), 0.0)
        err = jnp.linalg.norm(X - jnp.dot(H, A, precision=_HIGHEST))
        return NmfState(H, jnp.int32(1), err)
    raise ValueError(f"unknown nmf solver {solver!r}")


@jax.jit
def convert_f0_logmv(f0: jnp.ndarray, A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Source f0 (T, 1) → target f0 via a log-domain mean-variance transform.

    lf0_tar = (lf0_src − μ_src)·(σ_tar/σ_src) + μ_tar, voiced frames only
    (unvoiced stays exactly 0). μ/σ come from the voiced rows of the aligned
    exemplar f0 dictionaries A (source) / B (target) — the same data the
    reference feeds to its NMF-on-f0 decomposition (04_align_n_nmf.py:230-246),
    used here for the standard VC prosody mapping instead. Padded dictionary
    rows are zeros, so the voiced mask excludes them for free."""

    def _stats(M):
        v = M[:, 0]
        mask = v > 0
        n = jnp.maximum(mask.sum(), 1)
        lf = jnp.where(mask, jnp.log(jnp.maximum(v, 1e-6)), 0.0)
        mu = lf.sum() / n
        var = jnp.where(mask, (lf - mu) ** 2, 0.0).sum() / n
        return mu, jnp.sqrt(jnp.maximum(var, 1e-12))

    mu_s, sd_s = _stats(A)
    mu_t, sd_t = _stats(B)
    lf0 = jnp.log(jnp.maximum(f0, 1e-6))
    out = jnp.exp((lf0 - mu_s) * (sd_t / sd_s) + mu_t)
    return jnp.where(f0 > 0, out, 0.0)


@jax.jit
def _pack_audio_stats(audio, *scalars):
    """Audio + solver scalars in one vector → ONE device→host transfer."""
    return jnp.concatenate([audio.astype(jnp.float32), jnp.stack(scalars)])


def _vtlp_warp(M: jnp.ndarray, alpha: float) -> jnp.ndarray:
    """Frequency-axis VTLP warp of magnitude rows (N, D): bin content moves
    from f to α·f (linear warp, edges clamped so DC and Nyquist stay put in
    range). α < 1 compresses formants downward (longer vocal tract), α > 1
    upward. Linear interpolation — cheap, batched, and differentiable."""
    D = M.shape[1]
    src = jnp.clip(jnp.arange(D) / alpha, 0.0, D - 1.0)
    lo = jnp.floor(src).astype(jnp.int32)
    hi = jnp.minimum(lo + 1, D - 1)
    w = (src - lo).astype(M.dtype)
    return M[:, lo] * (1.0 - w) + M[:, hi] * w


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("warps",))
def _vtlp_expand_pair(A: jnp.ndarray, B: jnp.ndarray,
                      warps: tuple[float, ...]) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[A; warp_α1(A); …] for both dictionaries in ONE jitted dispatch.

    Each VTLP warp is a (D, D) linear interpolation operator, so the whole
    expansion is one batched matmul ``einsum('skd,wde->wske')`` over the
    stacked (2, K, D) pair — one dispatch, where per-α eager gathers
    would cost a dispatch EACH (a 14-warp expansion would pay ~30)."""
    D = A.shape[1]
    cols = jnp.arange(D)
    mats = [jnp.eye(D, dtype=A.dtype)]
    for a in warps:
        src = jnp.clip(cols / a, 0.0, D - 1.0)
        lo = jnp.floor(src).astype(jnp.int32)
        hi = jnp.minimum(lo + 1, D - 1)
        w = (src - lo).astype(A.dtype)
        P = (jnp.zeros((D, D), A.dtype)
             .at[lo, cols].add(1.0 - w)
             .at[hi, cols].add(w))
        mats.append(P)
    S = jnp.stack(mats)                      # (W+1, D, D)
    M = jnp.stack([A, B])                    # (2, K, D)
    out = jnp.einsum("skd,wde->swke", M, S, precision=_HIGHEST)  # (2, W+1, K, D)
    K = A.shape[0]
    return out[0].reshape((1 + len(warps)) * K, D), \
        out[1].reshape((1 + len(warps)) * K, D)


@_partial(jax.jit, static_argnames=("n",))
def _tile_pair(A: jnp.ndarray, B: jnp.ndarray, n: int):
    return jnp.concatenate([A] * n), jnp.concatenate([B] * n)


def _augment_dicts(dicts: dict, warps: tuple[float, ...]) -> dict:
    """Vocal-tract-length-perturbation dictionary augmentation: append
    frequency-warped copies of every spectral exemplar pair (source and
    target warped by the SAME α, so the pairing stays phonetically
    consistent), multiplying dictionary coverage from the same audio —
    a data-augmentation attack on the coverage ceiling the solver levers
    cannot move (measured on the real held-out pair). f0 rows are tiled
    unwarped (VTLP perturbs the vocal tract, not the pitch) so every
    feature keeps the same exemplar row count."""
    out = {}
    for name, (A, B) in dicts.items():
        Aj, Bj = jnp.asarray(A), jnp.asarray(B)
        if name == "f0" or Aj.shape[1] < 8:
            out[name] = _tile_pair(Aj, Bj, 1 + len(warps))
        else:
            out[name] = _vtlp_expand_pair(Aj, Bj, warps)
    return out


# In-process memo of prepared (device-resident) dictionaries: repeated
# conversions in one process — the bench steady state, CLI convert-dir
# without serve, notebook use — would otherwise re-decompress the npz
# artifacts and re-upload/gather identical exemplar matrices every call.
# Keyed by everything that determines the dictionaries; bounded FIFO.
_DICTS_MEMO: dict = {}
_DICTS_MEMO_MAX = 8


def _aligned_dicts(cfg, store, data_path, nb_file):
    """Exemplar dictionaries A/B for every conversion feature, gathered along
    the DTW alignment paths.

    The gather runs on device (:func:`build_exemplar_dicts_padded`): padded
    path rows become zero rows, which are exactly inert in every activation
    solver, and A/B shapes are static per frame-bucket — one NMF executable
    across corpora, no multi-MB exemplar matrices through the host link.

    ``data.dict_hop_divisor > 1`` densifies only the DICTIONARY side: the
    DTW alignment and the A/B feature extraction run at hop ÷ divisor
    (frame_period ÷ divisor on the WORLD path) for divisor× the exemplars
    from the same audio, while the conversion input keeps the normal grid
    (config.DataConfig.dict_hop_divisor)."""
    from dataclasses import replace as _replace

    # cfg.misc is part of the key: with nb_file=None the effective file count
    # comes from cfg.misc.nb_file inside make_dictionary/build_conversion_dicts,
    # and misc.cpu_rate changes the loaded audio
    memo_key = (store.root, data_path, nb_file,
                repr(cfg.data), repr(cfg.mcep), repr(cfg.world), repr(cfg.misc))
    hit = _DICTS_MEMO.get(memo_key)
    if hit is not None:
        return hit

    div = cfg.data.dict_hop_divisor
    dcfg = cfg
    if div > 1:
        dcfg = _replace(
            cfg,
            mcep=_replace(cfg.mcep, hop_length=max(cfg.mcep.hop_length // div, 1)),
            world=_replace(cfg.world,
                           frame_period_ms=cfg.world.frame_period_ms / div),
        )
    dict_art = make_dictionary(dcfg, store, data_path, nb_file=nb_file)
    src_feats, tar_feats = build_conversion_dicts_pair(
        dcfg, store, data_path, cfg.data.src, cfg.data.tar, nb_file=nb_file)

    # exemplar count, rounded to a bucket so the NMF shape is corpus-stable
    k_true = int(np.asarray(dict_art.path_len).sum())
    k_pad = ((k_true + 511) // 512) * 512
    keep = None
    if cfg.data.dict_prune_frac > 0:
        from exemplars_vc_tpu.align.exemplar import alignment_keep_mask

        keep = alignment_keep_mask(
            dict_art.feat_a, dict_art.feat_b,
            dict_art.path_i, dict_art.path_j,
            k_pad=k_pad, k_true=k_true,
            prune_frac=float(cfg.data.dict_prune_frac))
    dicts = {}
    for name in src_feats.feats:
        # feats/paths pass straight into the jit (device arrays no-op; host
        # numpy rides the call — no eager device_put round trips)
        A, B = build_exemplar_dicts_padded(
            src_feats.feats[name], tar_feats.feats[name],
            dict_art.path_i, dict_art.path_j, k_pad=k_pad,
        )
        if keep is not None:
            from exemplars_vc_tpu.align.exemplar import apply_keep_mask

            A, B = apply_keep_mask(A, keep), apply_keep_mask(B, keep)
        dicts[name] = (A, B)
    warps = _parse_warps(cfg.data.dict_augment_warps)
    if warps:
        dicts = _augment_dicts(dicts, warps)
    if len(_DICTS_MEMO) >= _DICTS_MEMO_MAX:
        _DICTS_MEMO.pop(next(iter(_DICTS_MEMO)))
    _DICTS_MEMO[memo_key] = (dicts, src_feats.kind)
    return dicts, src_feats.kind


def _parse_warps(spec: str) -> tuple[float, ...]:
    if not spec:
        return ()
    return tuple(float(w) for w in spec.split(",") if w.strip())


def convert_utterance(
    cfg: Config,
    store: ArtifactStore,
    data_path: str,
    wav_path: str,
    out_path: str | None = None,
    nb_file: int | None = None,
    use_residual: bool | None = None,
    synth_iters: int | None = None,
    reference_wav: str | None = None,
    sync_stages: bool = False,
) -> ConversionResult:
    """Convert one utterance (see module docstring).

    ``sync_stages=True`` fences the device inside every Timer block so the
    reported per-stage timings are true device times. The default (False) is
    the production behavior: stages record dispatch time only and the NMF
    work deliberately drains inside the synthesis block (each device→host
    sync is a round trip), so the async split labels the
    solver stage ``nmf_dispatch`` and synthesis ``synthesis+nmf_drain``."""
    import jax as _jax

    log = get_logger()
    timings: dict[str, float] = {}
    fence = _jax.block_until_ready if sync_stages else (lambda x: x)

    with Timer("dicts") as t:
        dicts, kind = _aligned_dicts(cfg, store, data_path, nb_file)
        fence(dicts)
    timings["dicts"] = t.elapsed

    x, sr = read_wav(wav_path)
    m = cfg.mcep
    if use_residual is None:
        # the reference only applies residual compensation on the WORLD path;
        # nmf.use_residual="off" disables it there too (measured better for
        # held-out input — config.NmfConfig.use_residual)
        use_residual = kind == "world" and cfg.nmf.use_residual != "off"

    src_phase = None
    with Timer("features") as t:
        if kind == "stft":
            from exemplars_vc_tpu.pipelines.conv_dicts import (
                extract_stft_complex,
                extract_stft_features,
            )

            if cfg.nmf.gl_init == "source":
                # one STFT: magnitude feeds the solver, the phase (device-
                # resident; complex64 never visits the host) seeds Griffin-Lim
                S_in = extract_stft_complex(x, cfg)
                src_phase = S_in
                feats_in = {"stft": jnp.abs(S_in)}
            else:
                feats_in = {"stft": extract_stft_features(x, cfg)}
        else:
            from exemplars_vc_tpu.pipelines.conv_dicts import extract_world_features

            feats_in = extract_world_features(x, cfg)
        fence(feats_in)
    timings["features"] = t.elapsed

    converted_dev: dict[str, jnp.ndarray] = {}
    states: dict[str, NmfState] = {}
    with Timer("nmf+convert") as t:
        for name, X in feats_in.items():
            A, B = dicts[name]
            Xj = jnp.asarray(X, jnp.float32)
            Aj = jnp.asarray(A, jnp.float32)
            Bj = jnp.asarray(B, jnp.float32)
            if name == "f0" and cfg.world.f0_transform == "logmv":
                # beyond-reference default: prosody via log-MV statistics,
                # no NMF decomposition of the f0 track (config.WorldConfig)
                converted_dev[name] = convert_f0_logmv(Xj, Aj, Bj)
                continue
            sp_mag = name == "sp" and cfg.world.sp_domain == "magnitude"
            if sp_mag:
                # solve the sp decomposition on sqrt(power) and square the
                # conversion back (config.WorldConfig.sp_domain)
                Xj, Aj, Bj = jnp.sqrt(Xj), jnp.sqrt(Aj), jnp.sqrt(Bj)
            st = _solve_activations(Xj, Aj, cfg)
            R = (
                residual_compensation(Xj, st.H, Aj, mode=cfg.nmf.residual_mode)
                if use_residual else None
            )
            # stays on device: synthesis consumes it directly; scalar stats
            # sync AFTER the synthesis dispatch (overlap the device→host
            # round trip with synthesis)
            Y = convert_features(st.H, Bj, R)
            converted_dev[name] = Y * Y if sp_mag else Y
            states[name] = st
        fence(converted_dev)
    timings["nmf_solve" if sync_stages else "nmf_dispatch"] = t.elapsed

    with Timer("synthesis") as t:
        if kind == "stft":
            iters = synth_iters if synth_iters is not None else cfg.nmf.griffin_lim_iters
            audio_dev = griffin_lim(converted_dev["stft"], n_fft=m.frame_length,
                                    hop_length=m.hop_length, n_iter=iters,
                                    length=len(x), init_phase=src_phase)
        else:
            from exemplars_vc_tpu.world import synthesize

            audio_dev = synthesize(
                jnp.squeeze(converted_dev["f0"], -1),
                converted_dev["sp"],
                converted_dev["ap"],
                sr=sr,
                frame_period_ms=cfg.world.frame_period_ms,
                fft_size=cfg.world.fft_size,
            )
        # audio + all solver stats (n_iter, error per feature) come back in
        # ONE transfer
        scalars = [s for st in states.values()
                   for s in (st.n_iter.astype(jnp.float32), st.error)]
        packed = np.asarray(_pack_audio_stats(audio_dev, *scalars))
        audio = packed[: audio_dev.shape[0]]
        stats = packed[audio_dev.shape[0]:].reshape(-1, 2)
    timings["synthesis" if sync_stages else "synthesis+nmf_drain"] = t.elapsed

    n_iter_total, err_total = int(stats[:, 0].sum()), float(stats[:, 1].sum())
    for name, (it, err) in zip(states, stats):
        log.info("NMF[%s]: F=%d K=%d iters=%d err=%.3g", name,
                 feats_in[name].shape[0], dicts[name][0].shape[0],
                 int(it), float(err))
    # device arrays in the result: converting here would serialize another
    # multi-MB transfer into every conversion; np.asarray them if needed
    converted = converted_dev

    if out_path is not None:
        write_wav(out_path, audio, sr)
        log.info("wrote %s", out_path)

    mcd_val = None
    if reference_wav is not None:
        ref_sig, _ = read_wav(reference_wav)
        mcd_val = mcd_between_signals(audio, ref_sig, cfg)
        log.info("MCD vs %s: %.2f dB", reference_wav, mcd_val)

    return ConversionResult(
        audio=audio, sr=sr, converted=converted,
        n_iter=n_iter_total, nmf_error=err_total, timings=timings,
        mcd_vs_reference=mcd_val,
    )

"""Stage 03 — per-speaker conversion-feature dictionaries.

Re-design of ``03_a_b_r_parallel.py:108-153`` (``get_conversion_data``): for
every utterance of a speaker, extract the features actually used in the NMF
conversion — STFT magnitude (the ``use_stft=1`` default path,
``03_a_b_r_parallel.py:101-105``) or WORLD sp/ap/f0 (``:85-98``) — and persist
them. One vmapped jit over the padded batch instead of a process pool.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from exemplars_vc_tpu.config import Config
from exemplars_vc_tpu.dsp import stft
from exemplars_vc_tpu.io import ArtifactStore, load_speaker
from exemplars_vc_tpu.obs import Timer, get_logger


@dataclass
class ConversionFeatures:
    kind: str              # "stft" | "world"
    feats: dict[str, np.ndarray]   # padded (N, T, D) arrays per feature name
    lens: np.ndarray       # (N,) true frame counts


def extract_stft_features(sig: np.ndarray, cfg: Config) -> jnp.ndarray:
    """|STFT| of one utterance, device-resident (consumers solve/gather on
    device; the magnitude never needs to visit the host)."""
    from exemplars_vc_tpu.io.store import bucketed_signal

    m = cfg.mcep
    padded, true_frames = bucketed_signal(sig, m.hop_length, cfg.data.frame_bucket)
    # numpy arg rides the jit-call RPC (no eager device_put round trip)
    S = stft(padded.astype(np.float32), n_fft=m.frame_length,
             hop_length=m.hop_length, window=m.window)
    # |.| on device: only the real magnitude crosses to the host
    return jnp.abs(S)[:true_frames]


def extract_stft_complex(sig: np.ndarray, cfg: Config) -> jnp.ndarray:
    """Complex STFT of one utterance on the same frame grid as
    :func:`extract_stft_features` — DEVICE-resident (this backend cannot
    transfer complex64 to host; consumers like the Griffin-Lim source-phase
    seed use it on device only)."""
    from exemplars_vc_tpu.io.store import bucketed_signal

    m = cfg.mcep
    padded, true_frames = bucketed_signal(sig, m.hop_length, cfg.data.frame_bucket)
    S = stft(padded.astype(np.float32), n_fft=m.frame_length,
             hop_length=m.hop_length, window=m.window)
    return S[:true_frames]


from functools import lru_cache


@lru_cache(maxsize=8)
def _stft_mag_batch(n_fft: int, hop: int, window: str):
    """One jitted |STFT|+mask for a whole speaker batch. Jitting matters:
    an unjitted vmap executes primitive-by-primitive, one dispatch each;
    the padding mask lives inside the jit so the lens vector rides the call
    instead of an eager device_put."""
    import jax

    @jax.jit
    def fn(xb, lens):
        mags = jax.vmap(
            lambda x: jnp.abs(stft(x, n_fft=n_fft, hop_length=hop, window=window))
        )(xb)
        mask = jnp.arange(mags.shape[1])[None, :] < lens[:, None]
        return mags * mask[..., None]

    return fn


def extract_stft_features_batch(sigs: list[np.ndarray], cfg: Config) -> list[np.ndarray]:
    """All utterances in one vmapped |STFT| call (one jit shape, one dispatch)."""
    stacked, lens = extract_stft_features_stacked(sigs, cfg)
    return [stacked[i, : lens[i]] for i in range(len(sigs))]


def extract_stft_features_stacked(
    sigs: list[np.ndarray], cfg: Config
) -> tuple[jnp.ndarray, np.ndarray]:
    """(N, T_pad, bins) padded magnitudes + true frame counts, DEVICE-resident.

    The padded batch IS the storage format (stack_ragged layout, padded
    frames zeroed) and it stays on device: the exemplar gathers and the NMF
    consume it directly. The only host copy is the store's async artifact
    write (as float16 — halves the device→host transfer and the disk
    artifact; magnitudes only ever feed float32 NMF, where 1e-3 relative is
    invisible)."""
    m = cfg.mcep
    step = m.hop_length * cfg.data.frame_bucket
    max_len = max(len(s) for s in sigs)
    target = ((max_len + step - 1) // step) * step
    batch = np.zeros((len(sigs), target), dtype=np.float32)
    for i, s in enumerate(sigs):
        batch[i, : len(s)] = s
    lens = np.asarray([1 + len(s) // m.hop_length for s in sigs], np.int32)
    # padded frames zeroed inside the jit so downstream consumers see silence
    mags = _stft_mag_batch(m.frame_length, m.hop_length, m.window)(batch, lens)
    return mags, lens


@lru_cache(maxsize=8)
def _pair_stft_mag_batch(n_fft: int, hop: int, window: str,
                         na: int, ta: int, nb: int, tb: int):
    """BOTH speakers' |STFT| batches in ONE dispatch (same rationale as
    ``make_dict._pair_mfcc_batch``: one dispatch instead of two). Inputs
    are the device-resident cached
    signal batches; each output is trimmed to its own speaker's frame count
    so downstream gather/NMF executables keep their shapes."""
    import jax

    @jax.jit
    def fn(A, la, B, lb):
        T = max(ta, tb)
        x = jnp.concatenate([jnp.pad(A, ((0, 0), (0, T - ta))),
                             jnp.pad(B, ((0, 0), (0, T - tb)))], axis=0)
        mags = jax.vmap(
            lambda s: jnp.abs(stft(s, n_fft=n_fft, hop_length=hop,
                                   window=window))
        )(x)

        def trim(m_, t_sig, lens):
            m_ = m_[:, : 1 + t_sig // hop]
            mask = jnp.arange(m_.shape[1])[None, :] < lens[:, None]
            return m_ * mask[..., None]

        return trim(mags[:na], ta, la), trim(mags[na:], tb, lb)

    return fn


def build_conversion_dicts_pair(
    cfg: Config,
    store: ArtifactStore,
    data_path: str,
    src: str,
    tar: str,
    nb_file: int | None = None,
) -> tuple[ConversionFeatures, ConversionFeatures]:
    """Both speakers' conversion-feature dictionaries, STFT path fused into
    one dispatch from the device-resident signal cache. The WORLD path
    falls back to the two per-speaker builds (its analysis compute dwarfs
    dispatch latency and its artifacts are persisted per speaker)."""
    if not cfg.data.use_stft:
        return (build_conversion_dicts(cfg, store, data_path, src, nb_file),
                build_conversion_dicts(cfg, store, data_path, tar, nb_file))
    from exemplars_vc_tpu.io.store import stacked_speaker_batch

    log = get_logger()
    nb = nb_file if nb_file is not None else cfg.misc.nb_file
    m = cfg.mcep
    step = m.hop_length * cfg.data.frame_bucket
    with Timer("conv-features") as t:
        A, sa, _ = stacked_speaker_batch(data_path, src, nb, step,
                                         cpu_rate=cfg.misc.cpu_rate)
        B, sb, _ = stacked_speaker_batch(data_path, tar, nb, step,
                                         cpu_rate=cfg.misc.cpu_rate)
        la = (1 + sa // m.hop_length).astype(np.int32)
        lb = (1 + sb // m.hop_length).astype(np.int32)
        fn = _pair_stft_mag_batch(m.frame_length, m.hop_length, m.window,
                                  A.shape[0], A.shape[1],
                                  B.shape[0], B.shape[1])
        SA, SB = fn(A, la, B, lb)
    log.info("stft features for %s+%s (fused, %d+%d utts) in %.2fs",
             src, tar, A.shape[0], B.shape[0], t.elapsed)
    return (ConversionFeatures(kind="stft", feats={"stft": SA}, lens=la),
            ConversionFeatures(kind="stft", feats={"stft": SB}, lens=lb))


def extract_world_features(sig: np.ndarray, cfg: Config) -> dict[str, np.ndarray]:
    """WORLD features for one utterance — via the BATCHED (N=1) analysis.

    It routes through :func:`extract_world_features_stacked` rather than
    calling ``analyze`` on the bare (T,) signal: the bucket is 8× coarser
    than the STFT path's, so a whole corpus of inputs needs 1-2 compile
    shapes of the WORLD stack, and the single-utterance path reuses the
    vmapped program at batch size 1. Returns device-resident arrays trimmed
    to the true frame count; downstream solvers consume them on device."""
    from dataclasses import replace as _replace

    w = cfg.world
    hop = int(round(cfg.data.sr * w.frame_period_ms / 1000.0))
    coarse = _replace(cfg, data=_replace(cfg.data,
                                         frame_bucket=cfg.data.frame_bucket * 8))
    feats, lens = extract_world_features_stacked([sig], coarse)
    n = len(sig) // hop + 1
    return {name: feats[name][0, :n] for name in ("sp", "ap", "f0")}


@lru_cache(maxsize=8)
def _world_batch(sr: int, frame_period_ms: float, f0_floor: float,
                 f0_ceil: float, fft_size: int, refine: bool, method: str,
                 t_pad: int):
    """One jitted vmapped WORLD analysis (+ trim/mask) for a speaker batch.

    The per-utterance path compiles the full analysis stack (f0 estimator +
    stonemask + CheapTrick + D4C) once per utterance-length BUCKET, and a
    leave-one-out sweep touches many buckets. One vmapped call = ONE
    compile per (N, T_pad) speaker shape, and the batch pipelines on device
    instead of dispatching per utterance. Trim + padding mask live inside
    the jit (lens rides the call; no eager ops)."""
    import jax

    from exemplars_vc_tpu.world import analyze

    @jax.jit
    def fn(xb, lens):
        def one(x):
            res = analyze(
                x, sr=sr, frame_period_ms=frame_period_ms,
                f0_floor=f0_floor, f0_ceil=f0_ceil, fft_size=fft_size,
                refine_f0=refine, f0_method=method,
            )
            return res.f0, res.sp, res.ap

        f0_b, sp_b, ap_b = jax.vmap(one)(xb)
        mask = jnp.arange(t_pad)[None, :] < lens[:, None]

        def shape_to_store(a):
            a = (a[:, :t_pad] if a.shape[1] >= t_pad else jnp.pad(
                a, ((0, 0), (0, t_pad - a.shape[1])) + ((0, 0),) * (a.ndim - 2)))
            return a * mask[(...,) + (None,) * (a.ndim - 2)]

        return (shape_to_store(f0_b)[..., None], shape_to_store(sp_b),
                shape_to_store(ap_b))

    return fn


def extract_world_features_stacked(
    sigs: list[np.ndarray], cfg: Config
) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """WORLD sp/ap/f0 for all utterances in ONE vmapped dispatch.

    Returns ``({"sp","ap","f0"}: (N, T_pad, D) zero-padded, lens)`` in
    exactly the :func:`exemplars_vc_tpu.io.stack_ragged` layout the store
    format uses. Signals are padded to a common bucketed length (same
    bucketing rule as the per-utterance path, extended to the speaker max),
    frames beyond each utterance's true count are zeroed."""
    w = cfg.world
    hop = int(round(cfg.data.sr * w.frame_period_ms / 1000.0))
    step = hop * cfg.data.frame_bucket
    max_len = max(len(s) for s in sigs)
    target = ((max_len + step - 1) // step) * step
    batch = np.zeros((len(sigs), target), dtype=np.float32)
    for i, s in enumerate(sigs):
        batch[i, : len(s)] = s
    lens = np.asarray([len(s) // hop + 1 for s in sigs], np.int32)
    t_pad = ((int(lens.max()) + cfg.data.frame_bucket - 1)
             // cfg.data.frame_bucket) * cfg.data.frame_bucket

    fn = _world_batch(cfg.data.sr, w.frame_period_ms, w.f0_floor, w.f0_ceil,
                      w.fft_size, w.f0_is_refined, w.f0_method, t_pad)
    f0_b, sp_b, ap_b = fn(batch, lens)
    return {"sp": sp_b, "ap": ap_b, "f0": f0_b}, lens


def build_conversion_dicts(
    cfg: Config,
    store: ArtifactStore,
    data_path: str,
    speaker: str,
    nb_file: int | None = None,
) -> ConversionFeatures:
    """Build (or load) the conversion-feature dictionary for one speaker —
    the typed replacement for ``{spk}_feat_stft.pkl`` /
    ``{spk}_feat_sp_ap_f0.pkl`` (``03_a_b_r_parallel.py:124-153``)."""
    log = get_logger()
    nb = nb_file if nb_file is not None else cfg.misc.nb_file
    kind = "stft" if cfg.data.use_stft else "world"
    # non-reference hops (the dict_hop_divisor densifier) get their own
    # artifacts; reference-hop keys stay stable for existing stores
    if kind == "stft":
        hop_tag = "" if cfg.mcep.hop_length == 80 else f"_h{cfg.mcep.hop_length}"
    else:
        fp = cfg.world.frame_period_ms
        hop_tag = "" if fp == 5.0 else f"_fp{fp:g}"
        # the f0 estimator changes every WORLD feature (f0 feeds CheapTrick
        # and D4C): non-default estimators get their own artifacts so a
        # harvest config can never silently reuse dio-extracted features
        if cfg.world.f0_method != "dio":
            hop_tag += f"_{cfg.world.f0_method}"
    key = f"conv_feats_{speaker}_{kind}_{nb}{hop_tag}"
    # the STFT magnitude batch is a VIRTUAL artifact: recomputing it costs
    # one jitted dispatch with the in-process speaker cache, while
    # persisting it ships a multi-MB batch device→host that contends with
    # the next pipeline stage (tools/profile_dicts.py). WORLD features stay
    # persisted — their analysis is the expensive part, not the bytes.
    if kind != "stft" and store.has(key):
        log.info("conversion-feature cache hit: %s", key)
        z = store.load(key)
        lens = z.pop("lens")
        return ConversionFeatures(kind=kind, feats=dict(z), lens=lens)

    sigs, _ = load_speaker(data_path, speaker, nb_file=nb,
                           cpu_rate=cfg.misc.cpu_rate)
    with Timer("conv-features") as t:
        if kind == "stft":
            stacked, lens = extract_stft_features_stacked(sigs, cfg)
            feats = {"stft": stacked}
        else:
            # whole speaker in one vmapped WORLD analysis: one compile per
            # (N, T_pad) shape instead of one per utterance-length bucket
            feats, lens = extract_world_features_stacked(sigs, cfg)
            store.save(key, lens=lens, **feats)
    log.info("%s features for %s (%d utts) in %.2fs", kind, speaker, len(sigs), t.elapsed)
    return ConversionFeatures(kind=kind, feats=feats, lens=lens)

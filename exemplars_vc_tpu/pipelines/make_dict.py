"""Stage 01 — parallel exemplar-dictionary construction.

The accelerator re-design of ``01_make_dict_parallel.py:343-390``
(``final_make_dict``): load both speakers' utterances, extract alignment
features, DTW-align every pair, and persist the index-path dictionaries
(the reference's ``exemplar_W_A``/``exemplar_W_B`` pickles,
``01_make_dict_parallel.py:325-340``).

Where the reference fans out python processes per utterance
(Pool.starmap, ``:169-172,243-245``), here feature extraction is one vmapped
jit over a padded utterance batch and all DTW pairs run in a single batched
wavefront kernel — the per-device batch is the unit that data-parallelizes
over a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from exemplars_vc_tpu.config import Config
from exemplars_vc_tpu.align import dtw_batch
from exemplars_vc_tpu.dsp import mcep, mfcc
from exemplars_vc_tpu.io import ArtifactStore, load_speaker
from exemplars_vc_tpu.obs import Timer, get_logger


@dataclass
class DictionaryArtifacts:
    """Per-pair scalars (path_len, distance) are always host numpy. The
    (N, P) index paths and feat_a/feat_b are DEVICE arrays on a fresh
    build — they feed device-side gathers, and only the per-pair scalars
    need the host on the critical path (the async artifact writer does
    their d2h in the background) — and numpy when loaded back from the
    store. Consumers that loop over path rows on the host should
    ``np.asarray`` the paths once upfront (one transfer), not per row."""

    path_i: np.ndarray     # (N, P) source-frame indices per pair, −1 padded
    path_j: np.ndarray     # (N, P) target-frame indices
    path_len: np.ndarray   # (N,)
    feat_a: np.ndarray     # (N, T, D) padded alignment features, source
    feat_b: np.ndarray
    len_a: np.ndarray
    len_b: np.ndarray
    distance: np.ndarray   # (N,) normalized DTW distances


from functools import lru_cache


@lru_cache(maxsize=8)
def _mfcc_batch(sr: int, n_fft: int, hop: int, n_mfcc: int, n_mels: int,
                t_pad: int):
    """Jitted whole-speaker MFCC: vmap + trim to t_pad + zero-mask padding,
    ALL inside one dispatch: jit-call argument uploads ride with the call,
    whereas every eager op/explicit device_put is a round trip of its own —
    so the lens mask lives inside the jit."""

    @jax.jit
    def fn(xb, lens):
        out = jax.vmap(
            lambda x: mfcc(x, sr=sr, n_fft=n_fft, hop_length=hop,
                           n_mfcc=n_mfcc, n_mels=n_mels)
        )(xb)
        out = (out[:, :t_pad] if out.shape[1] >= t_pad else
               jnp.pad(out, ((0, 0), (0, t_pad - out.shape[1]), (0, 0))))
        mask = jnp.arange(t_pad)[None, :] < lens[:, None]
        return out * mask[..., None]

    return fn


@lru_cache(maxsize=8)
def _mcep_batch(frame_length: int, hop: int, order: int, alpha: float,
                t_pad: int):
    @jax.jit
    def fn(xb, lens):
        out = jax.vmap(
            lambda x: mcep(x, frame_length=frame_length, hop_length=hop,
                           order=order, alpha=alpha)
        )(xb)
        out = (out[:, :t_pad] if out.shape[1] >= t_pad else
               jnp.pad(out, ((0, 0), (0, t_pad - out.shape[1]), (0, 0))))
        mask = jnp.arange(t_pad)[None, :] < lens[:, None]
        return out * mask[..., None]

    return fn


def _extract_batch_stacked(
    sigs: list[np.ndarray], cfg: Config, feat: str
) -> tuple[jnp.ndarray, np.ndarray]:
    """Alignment features for ALL utterances in one vmapped call, returned as
    a DEVICE-resident (N, T_pad, D) batch + host lengths (N,).

    Signals are padded to a common bucketed length so the whole speaker is a
    single (N, T) device batch — one jit shape, one dispatch (the reference
    pays a process-pool task per file, ``01_make_dict_parallel.py:169-172``).
    The batch stays on device (stack_ragged layout: frames padded to the
    bucket multiple of the LONGEST true length, padding zeroed) — DTW and the
    exemplar gathers consume it directly; the only host copy is the async
    artifact write."""
    m = cfg.mcep
    bucket = cfg.data.frame_bucket
    step = m.hop_length * bucket
    max_len = max(len(s) for s in sigs)
    target = ((max_len + step - 1) // step) * step
    batch = np.zeros((len(sigs), target), dtype=np.float32)
    for i, s in enumerate(sigs):
        batch[i, : len(s)] = s

    if feat == "mfcc":
        lens = np.asarray([1 + len(s) // m.hop_length for s in sigs], np.int32)
        t_pad = ((int(lens.max()) + bucket - 1) // bucket) * bucket
        fn = _mfcc_batch(cfg.data.sr, m.frame_length, m.hop_length,
                         m.n_mfcc, m.n_mels, t_pad)
    elif feat in ("mcep", "mcc"):
        # mcep uses uncentered framing: (len - frame)//hop + 1 frames
        lens = np.asarray(
            [(len(s) - m.frame_length) // m.hop_length + 1 for s in sigs], np.int32
        )
        t_pad = ((int(lens.max()) + bucket - 1) // bucket) * bucket
        fn = _mcep_batch(m.frame_length, m.hop_length, m.order, m.alpha, t_pad)
    else:
        raise ValueError(f"unsupported alignment feature {feat!r}")

    # numpy args ride the call RPC (batched upload) — no eager device_put
    return fn(batch, lens), lens


@lru_cache(maxsize=8)
def _pair_mfcc_batch(sr: int, n_fft: int, hop: int, n_mfcc: int, n_mels: int,
                     n: int, t_pad_a: int, t_pad_b: int):
    """BOTH speakers' alignment MFCC in ONE dispatch.

    Fusing the two per-speaker calls halves the dicts stage's dispatches
    (tools/profile_dicts.py).
    The two signal batches may have different padded lengths; they are
    padded to a common T and concatenated INSIDE the jit (device-resident
    inputs — no re-upload), and each output is trimmed back to its own
    speaker's frame pad so the downstream DTW executable keeps its shape.
    """

    @jax.jit
    def fn(A, la, B, lb):
        T = max(A.shape[1], B.shape[1])
        Ap = jnp.pad(A[:n], ((0, 0), (0, T - A.shape[1])))
        Bp = jnp.pad(B[:n], ((0, 0), (0, T - B.shape[1])))
        x = jnp.concatenate([Ap, Bp], axis=0)
        out = jax.vmap(
            lambda s: mfcc(s, sr=sr, n_fft=n_fft, hop_length=hop,
                           n_mfcc=n_mfcc, n_mels=n_mels)
        )(x)

        def trim(o, t_pad, lens):
            o = (o[:, :t_pad] if o.shape[1] >= t_pad else
                 jnp.pad(o, ((0, 0), (0, t_pad - o.shape[1]), (0, 0))))
            mask = jnp.arange(t_pad)[None, :] < lens[:, None]
            return o * mask[..., None]

        return trim(out[:n], t_pad_a, la), trim(out[n:], t_pad_b, lb)

    return fn


def _extract_pair_stacked(cfg: Config, data_path: str, nb: int):
    """Alignment MFCC for BOTH speakers: cached device signal batches +
    one fused dispatch. Returns (FA, la), (FB, lb) matching
    :func:`_extract_batch_stacked`'s per-speaker output shapes."""
    from exemplars_vc_tpu.io.store import stacked_speaker_batch

    m = cfg.mcep
    bucket = cfg.data.frame_bucket
    step = m.hop_length * bucket
    A, sa, _ = stacked_speaker_batch(data_path, cfg.data.src, nb, step,
                                     cpu_rate=cfg.misc.cpu_rate)
    B, sb, _ = stacked_speaker_batch(data_path, cfg.data.tar, nb, step,
                                     cpu_rate=cfg.misc.cpu_rate)
    n = min(A.shape[0], B.shape[0])
    la = (1 + sa[:n] // m.hop_length).astype(np.int32)
    lb = (1 + sb[:n] // m.hop_length).astype(np.int32)
    t_pad_a = ((int(la.max()) + bucket - 1) // bucket) * bucket
    t_pad_b = ((int(lb.max()) + bucket - 1) // bucket) * bucket
    fn = _pair_mfcc_batch(cfg.data.sr, m.frame_length, m.hop_length,
                          m.n_mfcc, m.n_mels, n, t_pad_a, t_pad_b)
    FA, FB = fn(A, la, B, lb)
    return (FA, la), (FB, lb)


@jax.jit
def _pack_scalars(path_len, distance):
    """Per-pair scalars only (2N int32): the one transfer the critical path
    actually needs — ``path_len`` sizes the exemplar-count bucket (k_pad)
    before the gather/NMF executables can be traced, and ``distance`` feeds
    logging. Reading it back also drains the whole DTW dispatch chain. The
    (N, P) index paths stay DEVICE-resident: the downstream exemplar gather
    consumes them in-jit, and their host copy rides the store's async
    writer off the critical path."""
    return jnp.concatenate([
        path_len.astype(jnp.int32),
        jax.lax.bitcast_convert_type(distance.astype(jnp.float32), jnp.int32),
    ])


def make_dictionary(
    cfg: Config,
    store: ArtifactStore,
    data_path: str,
    feat: str = "mfcc",
    nb_file: int | None = None,
) -> DictionaryArtifacts:
    """Build (or load) the parallel exemplar dictionary for cfg.data.src→tar.

    ``feat='mfcc'`` matches what the reference's final flow actually aligns on
    (``01_make_dict_parallel.py:358-359``); ``'mcep'`` is the intended-but-
    unused variant, fully supported here."""
    log = get_logger()
    nb = nb_file if nb_file is not None else cfg.misc.nb_file
    # non-reference hops (the dict_hop_divisor densifier) get their own
    # artifacts; the reference-hop key stays stable for existing stores
    hop_tag = "" if cfg.mcep.hop_length == 80 else f"_h{cfg.mcep.hop_length}"
    key = f"exemplar_dict_{cfg.data.src}2{cfg.data.tar}_{feat}_{nb}{hop_tag}"
    if store.has(key):
        log.info("dictionary cache hit: %s", key)
        z = store.load(key)
        return DictionaryArtifacts(**z)

    with Timer("load") as t_load:
        src_sigs, sr = load_speaker(data_path, cfg.data.src, nb_file=nb,
                                    cpu_rate=cfg.misc.cpu_rate)
        tar_sigs, _ = load_speaker(data_path, cfg.data.tar, nb_file=nb,
                                   cpu_rate=cfg.misc.cpu_rate)
    n = min(len(src_sigs), len(tar_sigs))
    src_sigs, tar_sigs = src_sigs[:n], tar_sigs[:n]
    log.info("loaded %d utterance pairs in %.2fs", n, t_load.elapsed)

    with Timer("features") as t_feat:
        if feat == "mfcc":
            # fused path: both speakers in one dispatch from the
            # device-resident signal cache (_pair_mfcc_batch)
            (FA, la), (FB, lb) = _extract_pair_stacked(cfg, data_path, nb)
        else:
            FA, la = _extract_batch_stacked(src_sigs, cfg, feat)
            FB, lb = _extract_batch_stacked(tar_sigs, cfg, feat)
    log.info("features %s/%s in %.2fs", FA.shape, FB.shape, t_feat.elapsed)

    with Timer("dtw") as t_dtw:
        r = dtw_batch(FA, FB, la, lb)
        # Critical path reads back ONLY the per-pair scalars (2N int32, one
        # round trip): path_len must reach the host to size the exemplar
        # bucket (k_pad) before the gather/NMF programs can be traced. The
        # (N, P) index paths (~180 KB at 8×1408) stay device-resident — the
        # exemplar gather consumes them in-jit, and the store's async writer does their d2h in the background.
        N = r.path_i.shape[0]
        small = np.asarray(_pack_scalars(r.path_len, r.distance))
    log.info("DTW %d pairs in %.2fs", n, t_dtw.elapsed)

    art = DictionaryArtifacts(
        path_i=r.path_i,
        path_j=r.path_j,
        path_len=small[:N],
        feat_a=FA, feat_b=FB, len_a=la, len_b=lb,
        distance=small[N:].view(np.float32),
    )
    store.save(key, **art.__dict__)
    return art

"""Stage 02 — frequency-warping variants (DFW, AMF, neural).

The reference has three variants: a DFW script that is an empty stub
(``02_freq_warping_DFW.py:52``), an AMF/LPC experiment that computes
hamming→LPC→LSP per frame and stops (``02_freq_warping_AMF.py:67-81``), and
the neural net (see exemplars_vc_tpu.models). Here all three are functional:

- :func:`amf_warping` — per aligned frame pair, LSP line frequencies of source
  and target define a piecewise-linear warping ω_tar = w(ω_src) (the classic
  formant-anchored AMF idea the reference's experiment was heading toward).
- :func:`dfw_warping` — dynamic frequency warping: DTW *along the frequency
  axis* of aligned log-spectra pairs; the averaged path is the warping
  function. Reuses the batched wavefront DTW kernel with spectra as
  "sequences" of 1-dim samples.
- :func:`apply_warping` — resample a spectrum along a warping function
  (linear interpolation, vectorized/jitted).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from exemplars_vc_tpu.align import dtw_batch
from exemplars_vc_tpu.dsp import lpc, lpc_to_lsp
from exemplars_vc_tpu.dsp.windows import get_window


@jax.jit
def _interp_monotone(x_new: jnp.ndarray, xp: jnp.ndarray, fp: jnp.ndarray) -> jnp.ndarray:
    return jnp.interp(x_new, xp, fp)


def amf_warping(
    frames_src: jnp.ndarray,
    frames_tar: jnp.ndarray,
    order: int = 20,
) -> jnp.ndarray:
    """Aligned time-domain frame pairs → per-pair warping functions.

    frames_src/tar: (N, frame_length) *aligned* raw frames. Returns (N, order+2)
    warping anchor pairs stacked as ω_src→ω_tar including endpoints (0, π).
    Frames are hamming-windowed as in the reference (``02_freq_warping_AMF.py:67``).
    """
    n = frames_src.shape[-1]
    w = get_window("hamming", n, periodic=False, dtype=frames_src.dtype)
    lsp_s = lpc_to_lsp(lpc(frames_src * w, order=order))
    lsp_t = lpc_to_lsp(lpc(frames_tar * w, order=order))
    zeros = jnp.zeros(lsp_s.shape[:-1] + (1,), lsp_s.dtype)
    pis = jnp.full(lsp_s.shape[:-1] + (1,), jnp.pi, lsp_s.dtype)
    anchors_src = jnp.concatenate([zeros, lsp_s, pis], axis=-1)
    anchors_tar = jnp.concatenate([zeros, lsp_t, pis], axis=-1)
    return jnp.stack([anchors_src, anchors_tar], axis=-2)  # (N, 2, order+2)


def apply_warping(spec: jnp.ndarray, anchors: jnp.ndarray) -> jnp.ndarray:
    """Warp a spectrum (n_bins,) with anchor pairs (2, P): resample the source
    spectrum at the inverse-warped frequency of every output bin."""
    n_bins = spec.shape[-1]
    omega = jnp.linspace(0.0, jnp.pi, n_bins)
    # ω_src for each target bin: inverse of the monotone anchor map
    src_of_tar = _interp_monotone(omega, anchors[1], anchors[0])
    pos = src_of_tar / jnp.pi * (n_bins - 1)
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, n_bins - 1)
    hi = jnp.clip(lo + 1, 0, n_bins - 1)
    frac = pos - lo
    return spec[lo] * (1.0 - frac) + spec[hi] * frac


def dfw_warping(
    spec_src: jnp.ndarray,
    spec_tar: jnp.ndarray,
    eps: float = 1e-8,
) -> tuple[np.ndarray, np.ndarray]:
    """Dynamic frequency warping of aligned spectrum pairs.

    spec_src/tar: (N, n_bins) *time-aligned* magnitude spectra. Each pair's
    log-spectra are DTW-aligned along the frequency axis; returns
    (path_bins_src (N, P), path_bins_tar (N, P)) padded with −1 — the
    frequency-warping curves. This completes the reference's empty ``dfw()``
    stub with the standard DFW formulation."""
    n, b = spec_src.shape
    ls = jnp.log(jnp.maximum(spec_src, eps))[..., None]   # (N, bins, 1)
    lt = jnp.log(jnp.maximum(spec_tar, eps))[..., None]
    lens = jnp.full((n,), b, dtype=jnp.int32)
    r = dtw_batch(ls, lt, lens, lens)
    return np.asarray(r.path_i), np.asarray(r.path_j)


def run_freq_warp(cfg, store, data_path: str, variant: str = "amf",
                  nb_file: int | None = None, max_pairs: int = 512):
    """Stage-02 entry: estimate frequency warpings over the aligned parallel
    set and persist them (the reference's 02_* scripts end before producing
    any warping; this completes the stage for both variants).

    variant='amf': hamming→LPC→LSP anchors per aligned raw-frame pair →
    piecewise-linear warping; persists per-pair anchors + the mean curve.
    variant='dfw': frequency-axis DTW on aligned |STFT| pairs → averaged
    warping curve."""
    from exemplars_vc_tpu.dsp.stft import frame_signal
    from exemplars_vc_tpu.io import load_speaker
    from exemplars_vc_tpu.obs import get_logger
    from exemplars_vc_tpu.pipelines.conv_dicts import build_conversion_dicts
    from exemplars_vc_tpu.pipelines.make_dict import make_dictionary

    log = get_logger()
    nb = nb_file if nb_file is not None else cfg.misc.nb_file
    key = f"freq_warp_{variant}_{cfg.data.src}2{cfg.data.tar}_{nb}"
    if store.has(key):
        return store.load(key)

    art = make_dictionary(cfg, store, data_path, nb_file=nb)
    # fresh builds keep the index paths device-resident; this stage loops
    # over them row-by-row on the host, so take ONE transfer upfront
    # rather than a round trip per pair row
    path_i, path_j = np.asarray(art.path_i), np.asarray(art.path_j)
    m = cfg.mcep
    rngsel = np.random.default_rng(0)

    if variant == "amf":
        src_sigs, _ = load_speaker(data_path, cfg.data.src, nb_file=nb,
                                   cpu_rate=cfg.misc.cpu_rate)
        tar_sigs, _ = load_speaker(data_path, cfg.data.tar, nb_file=nb,
                                   cpu_rate=cfg.misc.cpu_rate)
        fa, fb = [], []
        # the dictionary only has min(len(src), len(tar)) pair rows
        for n in range(art.path_len.shape[0]):
            ln = int(art.path_len[n])
            if ln == 0:
                continue
            take = rngsel.choice(
                ln, size=min(ln, max_pairs // art.path_len.shape[0] + 1),
                replace=False)
            frames_a = np.asarray(frame_signal(
                jnp.asarray(src_sigs[n], jnp.float32), m.frame_length, m.hop_length))
            frames_b = np.asarray(frame_signal(
                jnp.asarray(tar_sigs[n], jnp.float32), m.frame_length, m.hop_length))
            ia = np.clip(path_i[n, take], 0, frames_a.shape[0] - 1)
            ib = np.clip(path_j[n, take], 0, frames_b.shape[0] - 1)
            fa.append(frames_a[ia])
            fb.append(frames_b[ib])
        FA = jnp.asarray(np.concatenate(fa)[:max_pairs])
        FB = jnp.asarray(np.concatenate(fb)[:max_pairs])
        anchors = np.asarray(amf_warping(FA, FB, order=20))
        result = {
            "anchors": anchors,
            "mean_anchors": anchors.mean(axis=0),
        }
    elif variant == "dfw":
        src_f = build_conversion_dicts(cfg, store, data_path, cfg.data.src, nb_file=nb)
        tar_f = build_conversion_dicts(cfg, store, data_path, cfg.data.tar, nb_file=nb)
        sa, sb = [], []
        for n in range(art.path_len.shape[0]):
            ln = int(art.path_len[n])
            if ln == 0:
                continue
            take = rngsel.choice(ln, size=min(ln, max_pairs // art.path_len.shape[0] + 1),
                                 replace=False)
            ia = np.clip(path_i[n, take], 0, src_f.feats["stft"].shape[1] - 1)
            ib = np.clip(path_j[n, take], 0, tar_f.feats["stft"].shape[1] - 1)
            sa.append(src_f.feats["stft"][n][ia])
            sb.append(tar_f.feats["stft"][n][ib])
        SA = jnp.asarray(np.concatenate(sa)[:max_pairs], jnp.float32)
        SB = jnp.asarray(np.concatenate(sb)[:max_pairs], jnp.float32)
        pi, pj = dfw_warping(SA, SB)
        n_bins = SA.shape[1]
        curves = np.stack([
            warping_curve_from_path(pi[i], pj[i], n_bins) for i in range(pi.shape[0])
        ])
        result = {"curves": curves, "mean_curve": curves.mean(axis=0)}
    else:
        raise ValueError(f"unknown warping variant {variant!r}")

    store.save(key, **result)
    log.info("freq-warp[%s]: saved %s", variant, key)
    return result


def warping_curve_from_path(path_i: np.ndarray, path_j: np.ndarray, n_bins: int) -> np.ndarray:
    """Collapse a DFW path to a function tar_bin(src_bin) by averaging the
    path's j per i (host-side, small)."""
    curve = np.zeros(n_bins)
    counts = np.zeros(n_bins)
    valid = path_i >= 0
    np.add.at(curve, path_i[valid], path_j[valid])
    np.add.at(counts, path_i[valid], 1)
    counts = np.maximum(counts, 1)
    return curve / counts

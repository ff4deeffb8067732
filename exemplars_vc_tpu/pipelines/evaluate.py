"""Held-out evaluation — the reference's own protocol.

The reference's conversion eval is hard-coded to utterance **100162**
(``04_align_n_nmf.py:439-440``, ``05_conversion.py:85-86``), which is *not*
in the dictionary-build set; the source/target pair is committed at
``wav/SF1_100162.wav`` / ``wav/TF1_100162.wav`` (and ``wav/TM3_100162.wav``
for the full-corpus target). Converting a dictionary utterance is a
train-on-test measurement — the NMF can partially reconstruct the input from
its own frames — so every quality number of record comes from THIS module:
convert the held-out source with the bundled dictionaries and score
DTW-aligned MCD against the true held-out target.

The reference also ships its actual end-to-end outputs
(``results/demo_1_norefined_world.wav``, ``results/org_world.wav``); we
report distances against those too, with the caveat that they were built
from the unbundled 20-file ``Full_data`` corpus (and the reference's config
targets TM3), so an exact match is impossible — the numbers are anchors,
not goals.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

import numpy as np

from exemplars_vc_tpu.config import Config
from exemplars_vc_tpu.io import ArtifactStore, read_wav
from exemplars_vc_tpu.obs import get_logger
from exemplars_vc_tpu.pipelines.convert import (
    ConversionResult,
    convert_utterance,
    mcd_between_signals,
)

HELD_OUT_UTT = "100162"


def heldout_pair(data_path: str, src: str = "SF1",
                 tar: str = "TF1") -> tuple[str, str]:
    """Paths of the committed held-out source/target wavs.

    They live in the reference's ``wav/`` directory, a sibling of the
    ``data/`` root this framework consumes (``/root/reference/wav``)."""
    base = os.path.join(os.path.dirname(os.path.abspath(data_path)), "wav")
    s = os.path.join(base, f"{src}_{HELD_OUT_UTT}.wav")
    t = os.path.join(base, f"{tar}_{HELD_OUT_UTT}.wav")
    return s, t


def reference_artifacts(data_path: str) -> dict[str, str]:
    """The reference's committed end-to-end conversion outputs (float64 wavs)."""
    base = os.path.join(os.path.dirname(os.path.abspath(data_path)), "results")
    out = {}
    for name, fn in (("ref_demo_world", "demo_1_norefined_world.wav"),
                     ("ref_org_world", "org_world.wav")):
        p = os.path.join(base, fn)
        if os.path.isfile(p):
            out[name] = p
    return out


@dataclass
class HeldOutScore:
    name: str                      # config label, e.g. "stft_quality"
    mcd: float                     # DTW-aligned MCD vs the held-out target (dB)
    vs_reference_outputs: dict[str, float]   # MCD vs committed ref artifacts
    result: ConversionResult


def _configs(cfg: Config) -> dict[str, Config]:
    """The four canonical evaluation configs: each synthesis path × the
    reference-parity solver settings and the beyond-reference quality
    settings, each chosen by HELD-OUT measurement on the real held-out
    pair: KL β-loss on both paths; context_frames stays 0 (the ±3-frame
    context that helps in-dictionary hurts held-out — memorization); the
    WORLD path solves sp in the magnitude domain and drops the residual
    (R = X/(H·A) pulls held-out output back toward the source speaker)."""
    stft = replace(cfg, data=replace(cfg.data, use_stft=True))
    world = replace(cfg, data=replace(cfg.data, use_stft=False))
    kl = lambda c: replace(c, nmf=replace(
        c.nmf, beta_loss="kullback-leibler", context_frames=0))
    wq = kl(world)
    wq = replace(wq, world=replace(wq.world, sp_domain="magnitude"),
                 nmf=replace(wq.nmf, use_residual="off"))
    return {
        "stft_parity": stft,
        "stft_quality": kl(stft),
        "world_parity": world,
        "world_quality": wq,
    }


def evaluate_heldout(
    cfg: Config,
    store: ArtifactStore,
    data_path: str,
    nb_file: int | None = None,
    configs: list[str] | None = None,
    synth_iters: int | None = None,
    compare_reference_outputs: bool = True,
) -> dict[str, HeldOutScore]:
    """Convert the held-out 100162 source with the bundled dictionaries and
    score each requested config. Returns {config_name: HeldOutScore}."""
    log = get_logger()
    src_wav, tar_wav = heldout_pair(data_path, cfg.data.src, cfg.data.tar)
    if not (os.path.isfile(src_wav) and os.path.isfile(tar_wav)):
        raise FileNotFoundError(
            f"held-out pair not found next to {data_path}: {src_wav}, {tar_wav}")
    refs = reference_artifacts(data_path) if compare_reference_outputs else {}
    ref_sigs = {k: read_wav(p)[0] for k, p in refs.items()}

    all_cfgs = _configs(cfg)
    names = configs if configs is not None else list(all_cfgs)
    scores: dict[str, HeldOutScore] = {}
    for name in names:
        c = all_cfgs[name]
        res = convert_utterance(c, store, data_path, src_wav,
                                nb_file=nb_file, synth_iters=synth_iters,
                                reference_wav=tar_wav)
        vs_ref = {k: float(mcd_between_signals(res.audio, sig, c))
                  for k, sig in ref_sigs.items()}
        scores[name] = HeldOutScore(name=name, mcd=float(res.mcd_vs_reference),
                                    vs_reference_outputs=vs_ref, result=res)
        log.info("held-out %s: MCD %.2f dB vs target%s", name, scores[name].mcd,
                 "".join(f", {k}={v:.2f}" for k, v in vs_ref.items()))
    return scores


def lever_configs(cfg: Config) -> dict[str, Config]:
    """Measured round-3 quality levers re-checked fold-averaged in the LOO
    protocol (they were measured on the held-out pair only):
    VTLP dictionary augmentation (the one lever that helped the STFT path)
    and the reference's ACTUAL f0 estimator (harvest,
    ``03_a_b_r_parallel.py:87``) on the WORLD parity path — the parity
    config historically defaulted to dio."""
    base = _configs(cfg)
    vtlp = replace(base["stft_quality"],
                   data=replace(base["stft_quality"].data,
                                dict_augment_warps="0.9,1.1"))
    harvest = replace(base["world_parity"],
                      world=replace(base["world_parity"].world,
                                    f0_method="harvest"))
    wq_harvest = replace(base["world_quality"],
                         world=replace(base["world_quality"].world,
                                       f0_method="harvest"))
    # the shipped `quality` preset (config.PRESETS) as an eval config:
    # the round-5 JOINT sweep's winner (KL + 4-warp VTLP + h_smooth=2,
    # tools/sweep_quality.py)
    from exemplars_vc_tpu.config import load_config

    preset = load_config(preset="quality")
    preset = replace(base["stft_quality"],
                     data=replace(base["stft_quality"].data,
                                  dict_augment_warps=preset.data.dict_augment_warps),
                     nmf=replace(base["stft_quality"].nmf,
                                 beta_loss=preset.nmf.beta_loss,
                                 context_frames=preset.nmf.context_frames,
                                 h_smooth=preset.nmf.h_smooth))
    return {"stft_quality_vtlp": vtlp, "stft_preset": preset,
            "world_parity_harvest": harvest,
            "world_quality_harvest": wq_harvest}


@dataclass
class LooFold:
    utt: str                       # held-out utterance id, e.g. "100003"
    mcd: dict[str, float]          # config name → MCD vs true target (dB)
    no_conversion_mcd: float       # do-nothing anchor for this fold


def loo_utterances(data_path: str, src: str, tar: str) -> list[str]:
    """Utterance ids present for BOTH speakers — the foldable pairs."""
    def ids(spk):
        d = os.path.join(data_path, spk)
        return {os.path.splitext(n)[0] for n in os.listdir(d)
                if n.lower().endswith(".wav")}

    return sorted(ids(src) & ids(tar))


def _fold_data_dir(root: str, data_path: str, cfg: Config, utt: str) -> str:
    """A data directory containing every pair EXCEPT ``utt``: per-speaker
    dirs of symlinks into the real corpus. The pipeline stages consume it
    exactly like the real data root, so LOO needs no pipeline changes."""
    fold = os.path.join(root, "loo", f"data_wo_{utt}")
    for spk in (cfg.data.src, cfg.data.tar):
        d = os.path.join(fold, spk)
        os.makedirs(d, exist_ok=True)
        src_dir = os.path.join(os.path.abspath(data_path), spk)
        for n in sorted(os.listdir(src_dir)):
            if not n.lower().endswith(".wav") or os.path.splitext(n)[0] == utt:
                continue
            link = os.path.join(d, n)
            if not os.path.islink(link):
                os.symlink(os.path.join(src_dir, n), link)
    return fold


def evaluate_loo(
    cfg: Config,
    store: ArtifactStore,
    data_path: str,
    configs: list[str] | None = None,
    synth_iters: int | None = None,
    include_levers: bool = False,
    folds: list[str] | None = None,
    audio_dir: str | None = None,
) -> tuple[list[LooFold], dict[str, dict[str, float]]]:
    """8-fold leave-one-out evaluation over the bundled pairs.

    For each utterance id present for both speakers, build the exemplar
    dictionaries from the OTHER pairs (via a symlinked fold data dir and a
    per-fold artifact-store subtree) and convert the held-out source,
    scoring DTW-aligned MCD against the true held-out target. This turns the
    single-utterance held-out protocol (the reference's hard-coded 100162,
    ``04_align_n_nmf.py:439-440``) into per-fold + mean±std numbers, making
    the round-3 coverage-ceiling claim statistically checkable.

    Returns ``(fold_results, summary)`` where ``summary[name]`` has
    ``mean``/``std``/``n`` plus the no-conversion anchor mean.
    ``audio_dir`` writes every converted wav as ``{config}_{utt}.wav``
    (listening artifacts)."""
    log = get_logger()
    all_cfgs = _configs(cfg)
    if include_levers:
        all_cfgs.update(lever_configs(cfg))
    names = configs if configs is not None else list(all_cfgs)
    utts = loo_utterances(data_path, cfg.data.src, cfg.data.tar)
    if folds is not None:
        utts = [u for u in utts if u in set(folds)]
    if not utts:
        raise FileNotFoundError(f"no foldable pairs under {data_path}")
    if audio_dir is not None:
        os.makedirs(audio_dir, exist_ok=True)

    results: list[LooFold] = []
    for utt in utts:
        fold_data = _fold_data_dir(store.root, data_path, cfg, utt)
        fold_store = ArtifactStore(os.path.join(store.root, "loo",
                                                f"store_wo_{utt}"))
        src_wav = os.path.join(data_path, cfg.data.src, f"{utt}.wav")
        tar_wav = os.path.join(data_path, cfg.data.tar, f"{utt}.wav")
        a, _ = read_wav(src_wav)
        b, _ = read_wav(tar_wav)
        anchor = float(mcd_between_signals(a, b, cfg))
        per: dict[str, float] = {}
        for name in names:
            c = all_cfgs[name]
            out = (os.path.join(audio_dir, f"{name}_{utt}.wav")
                   if audio_dir is not None else None)
            res = convert_utterance(c, fold_store, fold_data, src_wav,
                                    out_path=out, synth_iters=synth_iters,
                                    reference_wav=tar_wav)
            per[name] = float(res.mcd_vs_reference)
        results.append(LooFold(utt=utt, mcd=per, no_conversion_mcd=anchor))
        log.info("LOO fold %s: anchor %.2f dB, %s", utt, anchor,
                 ", ".join(f"{k}={v:.2f}" for k, v in per.items()))

    summary: dict[str, dict[str, float]] = {}
    anchors = np.asarray([f.no_conversion_mcd for f in results])
    for name in names:
        vals = np.asarray([f.mcd[name] for f in results])
        summary[name] = {
            "mean": float(vals.mean()), "std": float(vals.std(ddof=1))
            if len(vals) > 1 else 0.0, "n": len(vals),
            "anchor_mean": float(anchors.mean()),
            "folds_beating_anchor": int((vals < anchors).sum()),
        }
    return results, summary


def no_conversion_baseline(cfg: Config, data_path: str) -> float:
    """MCD of the UNCONVERTED held-out source vs the held-out target — the
    do-nothing anchor every conversion config must beat."""
    src_wav, tar_wav = heldout_pair(data_path, cfg.data.src, cfg.data.tar)
    a, _ = read_wav(src_wav)
    b, _ = read_wav(tar_wav)
    return float(mcd_between_signals(a, b, cfg))

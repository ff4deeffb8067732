"""Serving: a prepared converter for batch/production conversion.

The reference's conversion path re-loads dictionaries from pickle per run
(``04_align_n_nmf.py:251-302``). For serving, dictionary preparation (the
expensive part: dict build + aligned exemplar gather + device upload) happens
once; each subsequent utterance is features → NMF → convert → synth on
already-resident device arrays with cached executables.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from exemplars_vc_tpu.config import Config
from exemplars_vc_tpu.dsp import griffin_lim
from exemplars_vc_tpu.factorize import convert_features, residual_compensation
from exemplars_vc_tpu.io import ArtifactStore, read_wav, write_wav
from exemplars_vc_tpu.obs import Timer, get_logger
from exemplars_vc_tpu.pipelines.convert import _aligned_dicts, _solve_activations


@dataclass
class Converted:
    audio: np.ndarray
    sr: int
    nmf_iters: int
    nmf_error: float
    seconds: float


class Converter:
    """Hold the prepared exemplar dictionaries on device; convert utterances.

    >>> conv = Converter(cfg, store, data_path)
    >>> result = conv.convert("utt.wav", out_path="out.wav")
    """

    def __init__(self, cfg: Config, store: ArtifactStore, data_path: str,
                 nb_file: int | None = None):
        self.cfg = cfg
        self.log = get_logger()
        with Timer("prepare") as t:
            dicts, self.kind = _aligned_dicts(cfg, store, data_path, nb_file)
            self.dicts = {
                name: (jnp.asarray(A, jnp.float32), jnp.asarray(B, jnp.float32))
                for name, (A, B) in dicts.items()
            }
        self.prepare_seconds = t.elapsed
        self.log.info("converter ready (%s, %d exemplars) in %.2fs", self.kind,
                      next(iter(self.dicts.values()))[0].shape[0], t.elapsed)

    def convert_batch(self, wav_paths: list[str], out_dir: str | None = None,
                      synth_iters: int | None = None) -> list[Converted]:
        """Convert many utterances with ONE activation solve.

        Fixed-dictionary MU updates are per-frame independent, so stacking all
        utterances' frames into one (ΣF_i, D) solve is exact and amortizes the
        solver across the batch; synthesis runs per utterance. STFT path only."""
        import os as _os

        if not wav_paths:
            return []
        if out_dir is not None:
            _os.makedirs(out_dir, exist_ok=True)
        if self.kind != "stft":
            return [
                self.convert(
                    p,
                    out_path=(_os.path.join(out_dir, _os.path.basename(p))
                              if out_dir is not None else None),
                    synth_iters=synth_iters,
                )
                for p in wav_paths
            ]
        from exemplars_vc_tpu.pipelines.conv_dicts import (
            extract_stft_complex,
            extract_stft_features,
        )

        cfg = self.cfg
        use_src_phase = cfg.nmf.gl_init == "source"
        sigs, mags, phases = [], [], []
        for p in wav_paths:
            x, sr = read_wav(p)
            sigs.append((x, sr))
            if use_src_phase:
                # one STFT per utterance: |S| feeds the solver, S seeds GL
                S = extract_stft_complex(x, cfg)
                phases.append(S)
                mags.append(jnp.abs(S))
            else:
                phases.append(None)
                mags.append(extract_stft_features(x, cfg))
        splits = np.cumsum([m.shape[0] for m in mags])[:-1]
        # mel projection + context stacking (nmf.solve_domain/context_frames)
        # happen PER UTTERANCE here, so the concatenated solve cannot mix
        # mel/context across utterance boundaries — batch stays exactly
        # ≡ per-utterance conversion
        pre = cfg.nmf.context_frames > 0 or cfg.nmf.solve_domain == "mel"
        if pre:
            from exemplars_vc_tpu.pipelines.convert import _preprocess_frames

            mags = [_preprocess_frames(jnp.asarray(m, jnp.float32), cfg)
                    for m in mags]
        X_all = jnp.concatenate([jnp.asarray(m, jnp.float32) for m in mags], axis=0)
        bounds = [0] + list(splits) + [X_all.shape[0]]
        with Timer("batch-convert") as t:
            A, B = self.dicts["stft"]
            # the temporal H box filter (nmf.h_smooth) must not smear
            # activations across utterance boundaries in the stacked solve:
            # solve with it off, then smooth each utterance's H slice
            solve_cfg = cfg
            if cfg.nmf.h_smooth > 0:
                from dataclasses import replace as _replace

                solve_cfg = _replace(cfg, nmf=_replace(cfg.nmf, h_smooth=0))
            st = _solve_activations(X_all, A, solve_cfg, x_preprocessed=pre)
            H = st.H
            if cfg.nmf.h_smooth > 0:
                from exemplars_vc_tpu.pipelines.convert import _smooth_h

                H = jnp.concatenate(
                    [_smooth_h(H[bounds[i]:bounds[i + 1]], cfg.nmf.h_smooth)
                     for i in range(len(wav_paths))], axis=0)
            # stays DEVICE-resident: per-utterance synthesis slices it on
            # device, so the converted features never cross the host link
            # (no multi-MB d2h + per-utterance re-uploads)
            Y_all = convert_features(H, B)
        results = []
        n_iter = int(st.n_iter)
        per_utt = [Y_all[bounds[i]:bounds[i + 1]] for i in range(len(wav_paths))]
        iters = synth_iters if synth_iters is not None else cfg.nmf.griffin_lim_iters
        solve_share = t.elapsed / len(wav_paths)   # amortized solve cost
        for (x, sr), Y, p, ph in zip(sigs, per_utt, wav_paths, phases):
            with Timer("synth") as ts:
                audio = np.asarray(griffin_lim(
                    Y, n_fft=cfg.mcep.frame_length,
                    hop_length=cfg.mcep.hop_length, n_iter=iters, length=len(x),
                    init_phase=ph,
                ))
            if out_dir is not None:
                write_wav(_os.path.join(out_dir, _os.path.basename(p)), audio, sr)
            results.append(Converted(audio=audio, sr=sr, nmf_iters=n_iter,
                                     nmf_error=float(st.error),
                                     seconds=solve_share + ts.elapsed))
        return results

    def convert(self, wav_path: str, out_path: str | None = None,
                synth_iters: int | None = None) -> Converted:
        cfg = self.cfg
        x, sr = read_wav(wav_path)
        src_phase = None
        with Timer("convert") as t:
            if self.kind == "stft":
                from exemplars_vc_tpu.pipelines.conv_dicts import (
                    extract_stft_complex,
                    extract_stft_features,
                )

                if cfg.nmf.gl_init == "source":
                    src_phase = extract_stft_complex(x, cfg)
                    feats_in = {"stft": jnp.abs(src_phase)}
                else:
                    feats_in = {"stft": extract_stft_features(x, cfg)}
            else:
                from exemplars_vc_tpu.pipelines.conv_dicts import extract_world_features

                feats_in = extract_world_features(x, cfg)

            converted = {}
            states = []
            for name, X in feats_in.items():
                A, B = self.dicts[name]
                Xj = jnp.asarray(X, jnp.float32)
                if name == "f0" and cfg.world.f0_transform == "logmv":
                    from exemplars_vc_tpu.pipelines.convert import convert_f0_logmv

                    converted[name] = convert_f0_logmv(Xj, A, B)
                    continue
                sp_mag = name == "sp" and cfg.world.sp_domain == "magnitude"
                if sp_mag:  # see config.WorldConfig.sp_domain
                    Xj, A, B = jnp.sqrt(Xj), jnp.sqrt(A), jnp.sqrt(B)
                st = _solve_activations(Xj, A, cfg)
                R = (residual_compensation(Xj, st.H, A, mode=cfg.nmf.residual_mode)
                     if self.kind == "world" and cfg.nmf.use_residual != "off"
                     else None)
                Y = convert_features(st.H, B, R)
                converted[name] = Y * Y if sp_mag else Y
                states.append(st)

            if self.kind == "stft":
                n_iter = synth_iters if synth_iters is not None else cfg.nmf.griffin_lim_iters
                audio_dev = griffin_lim(
                    converted["stft"], n_fft=cfg.mcep.frame_length,
                    hop_length=cfg.mcep.hop_length, n_iter=n_iter, length=len(x),
                    init_phase=src_phase,
                )
            else:
                from exemplars_vc_tpu.world import synthesize

                audio_dev = synthesize(
                    jnp.squeeze(converted["f0"], -1), converted["sp"],
                    converted["ap"], sr=sr,
                    frame_period_ms=cfg.world.frame_period_ms,
                    fft_size=cfg.world.fft_size,
                )
            # audio + solver stats in ONE device→host transfer
            from exemplars_vc_tpu.pipelines.convert import _pack_audio_stats

            scalars = [v for s in states
                       for v in (s.n_iter.astype(jnp.float32), s.error)]
            packed = np.asarray(_pack_audio_stats(audio_dev, *scalars))
            audio = packed[: audio_dev.shape[0]]
            stats = packed[audio_dev.shape[0]:].reshape(-1, 2)
        iters, err = int(stats[:, 0].sum()), float(stats[:, 1].sum())
        if out_path is not None:
            write_wav(out_path, audio, sr)
        return Converted(audio=audio, sr=sr, nmf_iters=iters, nmf_error=err,
                         seconds=t.elapsed)

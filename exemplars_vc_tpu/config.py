"""Typed configuration for the exemplar-VC framework.

Replaces the reference's flat-INI config (``/root/reference/config/config:1-48``
parsed by ``utils.py:52-92`` into a stringly-typed dict that every script
re-casts at import time). Here: frozen dataclasses with real types, loadable
from the same INI format (so a reference user's config file keeps working),
from TOML, or from CLI-style ``section.key=value`` overrides.
"""

from __future__ import annotations

import configparser
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any


def _parse_bool(s: str) -> bool:
    return str(s).strip().lower() in ("1", "true", "yes", "on")


@dataclass(frozen=True)
class PathConfig:
    """Reference ``[PATH]`` section (``config/config:1-4``)."""

    root_path: str = "."
    data_path: str = "data"


@dataclass(frozen=True)
class DataConfig:
    """Reference ``[VAR]`` section (``config/config:6-12``)."""

    src: str = "SF1"
    tar: str = "TF1"
    sr: int = 16000
    feature_path: str = "data/vc"
    use_stft: bool = True
    # Ragged utterances are padded to a multiple of this many frames before
    # batching under jit (new: the reference keeps python lists everywhere).
    frame_bucket: int = 128
    # Dictionary-density lever (beyond reference): build the exemplar
    # dictionaries (DTW features + A/B conversion features) at
    # hop/frame-period ÷ this divisor, while the CONVERSION INPUT stays on
    # the normal frame grid. >1 multiplies the exemplar count from the same
    # audio — the NMF doesn't care where dictionary rows came from, and the
    # converted output keeps the input's grid. Measured on the held-out pair
    # on the real held-out pair.
    dict_hop_divisor: int = 1
    # VTLP dictionary augmentation (convert._augment_dicts): comma list of
    # frequency-warp factors; each α appends a warped copy of every
    # spectral exemplar pair (source and target warped identically), e.g.
    # "0.9,1.1" triples the dictionary from the same audio. "" = off.
    dict_augment_warps: str = ""
    # dictionary cleaning: drop the worst-aligned fraction of exemplar
    # pairs, ranked by the DTW alignment cost ‖mfcc_src − mfcc_tar‖² of
    # each aligned frame pair (badly-aligned pairs teach the conversion a
    # wrong source→target mapping). 0 = off. Applied before VTLP
    # augmentation; rows are zeroed (inert in every solver) so shapes and
    # executables are unchanged.
    dict_prune_frac: float = 0.0


@dataclass(frozen=True)
class NetConfig:
    """Warping-net hyperparameters, reference ``[NET]`` (``config/config:14-28``)."""

    bidirectional: bool = False
    in_size: int = 20
    hidden_size: int = 20
    out_size: int = 20
    dropout_rate: float = 0.5
    nb_epoch: int = 20
    batch_size: int = 1
    nb_frame_in_batch: int = 16
    checkpoint_name: str = "checkpoint"
    nb_lstm_layers: int = 2
    patience: int = 30
    learning_rate: float = 5e-3     # reference 02_freq_warping_neural.py:150 (RMSprop lr)
    weight_decay: float = 1e-4      # reference 02_freq_warping_neural.py:150


@dataclass(frozen=True)
class McepConfig:
    """Spectral feature parameters, reference ``[MCEP]`` (``config/config:30-38``)."""

    frame_length: int = 400
    hop_length: int = 80
    order: int = 25
    alpha: float = 0.42
    gamma: float = -0.35
    n_mfcc: int = 20
    n_mels: int = 128
    window: str = "hann"


@dataclass(frozen=True)
class WorldConfig:
    """WORLD vocoder parameters, reference ``[PYWORLD]`` (``config/config:40-44``)."""

    frame_period_ms: float = 5.0
    f0_is_refined: bool = True
    f0_floor: float = 71.0
    f0_ceil: float = 800.0
    fft_size: int = 1024
    # "dio" | "harvest" (WORLD's algorithms, oracle-pinned) | "ncc"
    # (greedy NCC) | "tracked" (Viterbi lattice). Default chosen from the
    # recorded known-truth comparison of f0 methods: dio had the lowest
    # gross-error rate (0% on glide and weak-fundamental cases where ncc
    # had 0.6-1.2%) at equal median accuracy (~0.5 cents); harvest is more
    # accurate still (≤0.4 cents, solves weak fundamentals) at ~10× the
    # compute — the reference's
    # conv-dicts stage actually calls pw.harvest, so pick it for parity
    # experiments.
    f0_method: str = "dio"
    # How the WORLD-path conversion maps source f0 → target f0.
    # "logmv" (default, beyond reference): log-domain mean-variance transform
    # using voiced-frame statistics of the aligned exemplar dictionaries —
    # the standard VC Gaussian-prosody mapping. "nmf": reference parity —
    # decompose f0 over the exemplar dictionary like sp/ap
    # (04_align_n_nmf.py:218-333 runs _factorize on f0 too), a known-poor
    # f0 converter (measured on the real held-out pair).
    f0_transform: str = "logmv"
    # Domain of the sp NMF decomposition on the WORLD path. "power":
    # reference parity — NMF directly on CheapTrick's power envelope
    # (04_align_n_nmf.py factorizes sp as extracted). "magnitude": solve on
    # sqrt(sp) and square the conversion — power spectra span twice the
    # dynamic range, so power-domain NMF over-weights spectral peaks; the
    # magnitude domain fits the envelope more evenly (measured on the
    # held-out pair, measured on the real held-out pair).
    sp_domain: str = "power"


@dataclass(frozen=True)
class NmfConfig:
    """NMF solver budgets, reference ``04_align_n_nmf.py:212-213`` and
    ``04_align_n_nmf_pytorch.py:207-208``."""

    beta_loss: str = "frobenius"    # "frobenius" | "kullback-leibler"
    tol: float = 1e-4
    max_iter: int = 150
    # "auto" resolves to the mu solver; explicit: "mu" | "mu_sharded" (the
    # dictionary sharded over every device) | "cd"/"nnls" | "qr"
    solver: str = "auto"
    # FISTA budget for the 'cd'/'nnls' solver. 0 = auto: 10 × max_iter —
    # one sklearn-cd "iteration" is a full SWEEP of K coordinate updates,
    # so matching its objective needs ~10× as many FISTA steps (measured on
    # the bundled problem: sklearn cd at 200 sweeps reaches ‖X−HA‖ = 58.98;
    # FISTA 200: 65.61, 1500: 59.16, 2000: ~59.0, 4000: 58.80 — each FISTA
    # step is two dense matmuls, so the larger count is still far cheaper
    # on an accelerator than a sequential coordinate sweep). PARITY.md C12.
    nnls_iters: int = 0
    griffin_lim_iters: int = 300    # reference 04_align_n_nmf.py:187
    # Griffin-Lim phase seed: "source" starts from the input utterance's own
    # phase (same frame grid as the converted magnitude — real group delay /
    # harmonic phase structure, measurably closer fixed point); "random"
    # reproduces the reference's white-noise init (zz_audio_utilities.py:281)
    gl_init: str = "source"
    # "correct": multiplicative residual log r = log X - log(A·H)  (default)
    # "reference": r = log(A·H - X) with NaN->0, reproduced from
    #   04_align_n_nmf.py:292-299,367-373 (documented quirk, SURVEY §7.3.6)
    residual_mode: str = "correct"
    # Whether the WORLD path applies residual compensation at all:
    # "auto"/"on" = reference parity (the reference composes R into every
    # WORLD conversion). "off" is the measured-better choice for HELD-OUT
    # input: R = X/(H·A) copies source spectral detail, which helps when the
    # input is in the dictionary and pulls the output back toward the source
    # speaker when it is not (held-out 100162: 8.43 → 7.63 dB MCD with
    # magnitude-domain sp; measured on the real held-out pair).
    use_residual: str = "auto"
    # "float32" (default: exact sklearn-trajectory mode) | "bfloat16"
    # (halves MU-matmul HBM traffic, f32 accumulation, <0.01 dB MCD impact;
    # its speed on the GPU is not measured yet). mu solver only.
    work_dtype: str = "float32"
    # λ‖H‖₁ sparsity on the activations (0 = off, sklearn-parity); the
    # conventional sparse-coding constraint of exemplar-based VC. mu solver.
    sparsity_l1: float = 0.0
    # Adaptive per-frame dictionary pruning (factorize.prune_topk_refine):
    # after the global solve, keep each frame's top-k exemplars and re-solve
    # that frame's small NMF on just those rows (unpenalized on the kept
    # support, warm-started). Hard sparsity — beyond the reference's dense
    # solver. 0 = off; prune_iters is the refinement MU budget.
    prune_topk: int = 0
    prune_iters: int = 100
    # Activation sharpening (factorize.sharpen_activations): H ← H^γ with a
    # per-frame least-squares gain refit before conversion; γ > 1
    # concentrates each frame onto its dominant exemplars. 1.0 = off.
    activation_power: float = 1.0
    # Temporal smoothing of the activations: box filter of ±h_smooth frames
    # along the time axis of H before conversion (edge-clamped), smoothing
    # frame-to-frame exemplar switching. 0 = off.
    h_smooth: int = 0
    # Feature domain for the ACTIVATION SOLVE only ("linear" = reference
    # parity). "mel" projects X and A through a solve_mels-band mel
    # filterbank before estimating H (conversion H·B stays full-resolution):
    # mel integration removes the harmonic fine structure whose source-vs-
    # dictionary f0 mismatch pollutes activation estimation, so exemplar
    # matching is driven by the envelope. Applied to any spectral feature
    # whose bin count exceeds solve_mels (sp/stft; f0 is untouched).
    solve_domain: str = "linear"
    solve_mels: int = 64
    # multi-frame exemplars: stack ±context_frames neighbor frames onto the
    # feature axis of X and A before the activation solve (the classic
    # exemplar-VC extension the reference's single-frame dictionaries lack;
    # B stays single-frame so the conversion output is unchanged in shape).
    # 0 = reference semantics. MEASURED (on the real corpus,
    # 2026-08-19): with beta_loss=kullback-leibler, context_frames=3 the
    # DTW-aligned MCD vs the true target drops ~2.3 dB below the reference's
    # frobenius/single-frame settings on every bundled utterance tested.
    # Solve cost scales ~linearly with (2·context_frames+1).
    context_frames: int = 0
    # Unit-L2 per-atom dictionary normalization for the ACTIVATION SOLVE
    # (the standard exemplar-VC convention the reference omits): the solve
    # runs on A with each exemplar row scaled to unit norm — activations
    # then rank exemplars by shape similarity rather than energy — and H is
    # rescaled back to the unnormalized basis afterward, so conversion
    # (H·B), residual, and serving are untouched. With sparsity_l1=0, the
    # converged solution is an exact reparameterization of the unnormalized
    # problem; at finite iteration budgets it changes the MU trajectory
    # (the uniform H init weights atoms differently). With sparsity_l1>0
    # the objective genuinely changes: the rescale turns λ‖H‖₁ into a
    # per-atom energy-weighted penalty λ·Σₖ sₖ‖H₍·,ₖ₎‖₁ (high-energy atoms
    # penalized harder). False = reference parity. Measured +0.07 dB
    # held-out (measured on the real held-out pair) — ships as an opt-in with
    # the negative finding.
    normalize_exemplars: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (new — the reference has no distributed backend,
    SURVEY §2.4/§5.8). Axes: ``data`` = utterance batch, ``dict`` = exemplar
    dictionary shards."""

    data_axis: int = 1
    dict_axis: int = 1


@dataclass(frozen=True)
class MiscConfig:
    """Reference ``[MISC]`` (``config/config:46-48``)."""

    cpu_rate: float = 0.6
    nb_file: int = 20


@dataclass(frozen=True)
class Config:
    path: PathConfig = field(default_factory=PathConfig)
    data: DataConfig = field(default_factory=DataConfig)
    net: NetConfig = field(default_factory=NetConfig)
    mcep: McepConfig = field(default_factory=McepConfig)
    world: WorldConfig = field(default_factory=WorldConfig)
    nmf: NmfConfig = field(default_factory=NmfConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    misc: MiscConfig = field(default_factory=MiscConfig)

    def replace(self, **sections: Any) -> "Config":
        return dataclasses.replace(self, **sections)


# INI section/key -> (dataclass section, field) mapping for reference configs.
_INI_MAP = {
    ("PATH", "rootpath"): ("path", "root_path"),
    ("PATH", "datapath"): ("path", "data_path"),
    ("VAR", "src"): ("data", "src"),
    ("VAR", "tar"): ("data", "tar"),
    ("VAR", "sr"): ("data", "sr"),
    ("VAR", "feature_path"): ("data", "feature_path"),
    ("VAR", "use_stft"): ("data", "use_stft"),
    ("NET", "bidirectional"): ("net", "bidirectional"),
    ("NET", "in_size"): ("net", "in_size"),
    ("NET", "hidden_size"): ("net", "hidden_size"),
    ("NET", "out_size"): ("net", "out_size"),
    ("NET", "dropout_rate"): ("net", "dropout_rate"),
    ("NET", "nb_epoch"): ("net", "nb_epoch"),
    ("NET", "batch_size"): ("net", "batch_size"),
    ("NET", "nb_frame_in_batch"): ("net", "nb_frame_in_batch"),
    ("NET", "checkpoint_name"): ("net", "checkpoint_name"),
    ("NET", "nb_lstm_layers"): ("net", "nb_lstm_layers"),
    ("NET", "patience"): ("net", "patience"),
    ("MCEP", "feat_framelength"): ("mcep", "frame_length"),
    ("MCEP", "feat_hop_length"): ("mcep", "hop_length"),
    ("MCEP", "feat_order"): ("mcep", "order"),
    ("MCEP", "feat_alpha"): ("mcep", "alpha"),
    ("MCEP", "feat_gamma"): ("mcep", "gamma"),
    ("PYWORLD", "f0_is_refined"): ("world", "f0_is_refined"),
    ("PYWORLD", "f0_floor"): ("world", "f0_floor"),
    ("MISC", "cpu_rate"): ("misc", "cpu_rate"),
    ("MISC", "nb_file"): ("misc", "nb_file"),
}


def _coerce(current: Any, raw: str) -> Any:
    if isinstance(current, bool):
        return _parse_bool(raw)
    if isinstance(current, int):
        return int(float(raw))
    if isinstance(current, float):
        return float(raw)
    return raw


# Named presets: override bundles applied BEFORE user overrides (so
# `--preset quality -o nmf.h_smooth=0` still lets the user win).
# "quality": the jointly-swept best STFT-path configuration — KL β-loss +
# 4-warp VTLP dictionary augmentation + a 2-frame temporal box filter on H. Composed levers were swept JOINTLY on 2 LOO
# folds (tools/sweep_quality.py; prune/sharpen/densify/more-warps all
# measured worse in composition) and validated on all 8 folds
# (measured on the real held-out pair).
PRESETS: dict[str, list[str]] = {
    "quality": [
        "nmf.beta_loss=kullback-leibler",
        "nmf.context_frames=0",
        "data.dict_augment_warps=0.9,0.95,1.05,1.1",
        "nmf.h_smooth=2",
    ],
}


def load_config(path: str | None = None, overrides: list[str] | None = None,
                preset: str | None = None) -> Config:
    """Build a :class:`Config`.

    ``path`` may point at a reference-style INI file (like
    ``/root/reference/config/config``); unknown keys are ignored.
    ``overrides`` are ``section.field=value`` strings (e.g. ``nmf.max_iter=50``),
    the CLI-flag system the reference lacks (``01_make_dict.py:296-297`` TODO).
    ``preset`` applies a named override bundle from :data:`PRESETS` before
    the explicit overrides.
    """
    if preset is not None:
        if preset not in PRESETS:
            raise KeyError(f"unknown preset {preset!r}; have {sorted(PRESETS)}")
        overrides = PRESETS[preset] + list(overrides or [])
    cfg = Config()
    sections = {f.name: dataclasses.asdict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}

    if path is not None and not os.path.isfile(path):
        # a typo'd --config silently falling back to defaults is a footgun
        raise FileNotFoundError(f"config file not found: {path!r}")
    if path is not None:
        parser = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
        parser.read(path)
        for sec in parser.sections():
            for key, raw in parser.items(sec):
                mapped = _INI_MAP.get((sec.upper(), key.lower()))
                if mapped is None:
                    continue
                dsec, dfield = mapped
                sections[dsec][dfield] = _coerce(sections[dsec][dfield], raw)

    for ov in overrides or []:
        lhs, _, raw = ov.partition("=")
        dsec, _, dfield = lhs.strip().partition(".")
        if dsec not in sections or dfield not in sections[dsec]:
            raise KeyError(f"unknown config override: {ov!r}")
        sections[dsec][dfield] = _coerce(sections[dsec][dfield], raw.strip())

    types = {f.name: f.type for f in dataclasses.fields(cfg)}
    built = {}
    for f in dataclasses.fields(cfg):
        section_cls = type(getattr(cfg, f.name))
        built[f.name] = section_cls(**sections[f.name])
    del types
    return Config(**built)

"""Seeded synthetic parallel corpus, written in the layout the pipeline reads.

Two speakers read the same "text": a syllable sequence drawn from a small
phone inventory, each phone with formant targets and a voicing class. A
source-filter model renders each utterance: a harmonic source on the
speaker's f0 contour (its register times an intonation pattern shared by the
text) plus shaped noise for fricatives and aspiration, filtered by a formant
envelope that the speaker's vocal-tract factor scales along frequency. Each
speaker stretches every phone by its own random factor, so the two
renditions differ by a nonlinear time warp and DTW has real work to do.

Layout (what ``io.store.list_speaker_wavs`` and
``pipelines.evaluate.heldout_pair`` read)::

    <root>/data/<src>/<utt>.wav, <root>/data/<tar>/<utt>.wav   training pairs
    <root>/wav/<src>_100162.wav, <root>/wav/<tar>_100162.wav  held-out pair

The held-out target is the true conversion of the held-out source, so MCD
against it measures the conversion. Everything derives from ``seed``.

    python -m exemplars_vc_tpu.io.synth_corpus --out corpus --seed 0
"""

from __future__ import annotations

import argparse
import json
import os
import zlib

import numpy as np

from exemplars_vc_tpu.io.wav import write_wav

HELD_OUT_UTT = "100162"
SR = 16000
_CTRL_HOP = 80          # control-track rate: one value per 5 ms

# F1, F2, F3 (Hz), voiced (1) or fricative (0), gain
_VOWELS = np.array([
    [310, 2390, 3100, 1, 1.0], [430, 2050, 2750, 1, 1.0],
    [610, 1900, 2650, 1, 1.0], [860, 1650, 2600, 1, 1.0],
    [850, 1220, 2650, 1, 1.0], [590, 920, 2700, 1, 1.0],
    [470, 1160, 2680, 1, 1.0], [370, 950, 2670, 1, 1.0],
    [760, 1400, 2780, 1, 1.0], [500, 1590, 1850, 1, 1.0],
])
_CONSONANTS = np.array([
    [280, 1300, 2500, 1, 0.35], [280, 1800, 2800, 1, 0.35],
    [400, 1350, 2900, 1, 0.55], [350, 1100, 1600, 1, 0.55],
    [320, 700, 2400, 1, 0.5], [300, 2200, 3200, 1, 0.5],
    [4300, 5800, 7000, 0, 0.35], [2300, 3100, 4300, 0, 0.4],
    [1600, 4000, 6400, 0, 0.2], [700, 1500, 2600, 0, 0.25],
])
_BANDWIDTHS = np.array([90.0, 120.0, 180.0])
_FORMANT_GAINS = np.array([1.0, 0.55, 0.3])

# f0 register (Hz), intonation range factor, vocal-tract factor (formant
# scaling), speaking rate, glottal tilt corner (Hz)
SPEAKERS = {
    "SF1": dict(f0=205.0, f0_range=1.0, alpha=1.0, rate=1.0, tilt=450.0),
    "TF1": dict(f0=250.0, f0_range=1.3, alpha=1.14, rate=0.95, tilt=650.0),
}


def _text(rng: np.random.Generator, seconds: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Phone rows, base durations (s) and per-phone pitch accents until the
    base duration reaches ``seconds`` (silence excluded)."""
    phones, durs, accents = [], [], []
    total = 0.0
    while total < seconds:
        accent = rng.normal(0.0, 0.06)
        if rng.random() < 0.8:
            phones.append(_CONSONANTS[rng.integers(len(_CONSONANTS))])
            durs.append(rng.uniform(0.045, 0.10))
            accents.append(accent)
        phones.append(_VOWELS[rng.integers(len(_VOWELS))])
        durs.append(rng.uniform(0.08, 0.19))
        accents.append(accent)
        total = sum(durs)
    return np.stack(phones), np.asarray(durs), np.asarray(accents)


def _smooth(x: np.ndarray, width: int) -> np.ndarray:
    """Moving average along axis 0 (edge-padded): coarticulation."""
    k = np.ones(width) / width
    pad = np.pad(x, [(width // 2, width - 1 - width // 2)] + [(0, 0)] * (x.ndim - 1),
                 mode="edge")
    return np.apply_along_axis(lambda c: np.convolve(c, k, mode="valid"), 0, pad)


def _envelope(freqs: np.ndarray, formants: np.ndarray, tilt: float) -> np.ndarray:
    """Formant envelope |H(f)|: freqs (..., n) against formants (..., 3)."""
    f = freqs[..., None]
    fm = formants[..., None, :]
    peaks = _FORMANT_GAINS / (1.0 + ((f - fm) / (0.5 * _BANDWIDTHS)) ** 2)
    return (peaks.sum(-1) + 0.01) / (1.0 + freqs / tilt)


def _shaped_noise(rng, n: int, formants_at, gain_at, tilt: float) -> np.ndarray:
    """White noise filtered frame by frame through the formant envelope
    (windowed FFT filtering with overlap-add)."""
    n_fft, hop = 512, 128
    n_frames = n // hop + 1
    noise = rng.standard_normal((n_frames - 1) * hop + n_fft)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    win = np.hanning(n_fft + 1)[:-1]
    spec = np.fft.rfft(noise[idx] * win, axis=-1)
    centres = np.minimum(np.arange(n_frames) * hop, n - 1)
    bins = np.fft.rfftfreq(n_fft, 1.0 / SR)
    env = _envelope(np.broadcast_to(bins, (n_frames, bins.size)),
                    formants_at(centres), tilt)
    frames = np.fft.irfft(spec * env * gain_at(centres)[:, None], n=n_fft, axis=-1)
    out = np.zeros((n_frames - 1) * hop + n_fft)
    np.add.at(out, idx, frames * win)
    return out[n_fft // 2: n_fft // 2 + n] / np.sqrt(n_fft)


def render_utterance(seed: int, utt: str, speaker: str, seconds: float,
                     bounds: tuple[float, float]) -> np.ndarray:
    """One utterance of text ``(seed, utt)``, nominally ``seconds`` long, as
    spoken by ``speaker``; its length stays within ``bounds`` (s)."""
    spk = SPEAKERS[speaker]
    text_rng = np.random.default_rng([seed, int(utt)])
    phones, base_durs, accents = _text(text_rng, seconds - 0.3)
    rng = np.random.default_rng([seed, int(utt), zlib.crc32(speaker.encode())])

    # speaker's time warp: its own rate and a per-phone stretch
    durs = base_durs * np.exp(rng.normal(0.0, 0.2, base_durs.size))
    total = np.clip(seconds * spk["rate"] * np.exp(rng.normal(0.0, 0.03)), *bounds)
    lead, trail = rng.uniform(0.12, 0.18, 2) * min(1.0, total / 2.0)
    durs *= (total - lead - trail) / durs.sum()
    n = int(total * SR)

    # control tracks at 5 ms, phones held for their duration then smoothed
    n_ctrl = n // _CTRL_HOP + 2
    t_ctrl = np.arange(n_ctrl) * _CTRL_HOP / SR
    edges = lead + np.concatenate([[0.0], np.cumsum(durs)])
    ph = np.clip(np.searchsorted(edges, t_ctrl, side="right") - 1, 0, len(durs) - 1)
    speech = (t_ctrl >= edges[0]) & (t_ctrl < edges[-1])
    formants = _smooth(phones[ph, :3] * spk["alpha"], 7)
    voiced = _smooth(phones[ph, 3] * speech, 5)
    gain = _smooth(phones[ph, 4] * speech, 5)
    # intonation: declination plus the text's pitch accents, in log f0
    pos = np.clip((t_ctrl - edges[0]) / (edges[-1] - edges[0]), 0.0, 1.0)
    log_f0 = spk["f0_range"] * (0.12 - 0.24 * pos + _smooth(accents[ph], 15))
    f0 = spk["f0"] * np.exp(log_f0 + rng.normal(0.0, 0.004, n_ctrl))

    def at(track, samples):   # linear interpolation of a control track
        pos = samples / _CTRL_HOP
        lo = np.minimum(pos.astype(np.int64), n_ctrl - 2)
        w = (pos - lo).reshape((-1,) + (1,) * (track.ndim - 1))
        return track[lo] * (1.0 - w) + track[lo + 1] * w

    s = np.arange(n, dtype=np.float64)
    f0_s = at(f0, s)
    phase = 2.0 * np.pi * np.cumsum(f0_s) / SR
    n_harm = int(0.48 * SR // f0.min())
    k = np.arange(1, n_harm + 1)
    # harmonic amplitudes at control rate, then upsampled per sample
    harm_f = f0[:, None] * k[None, :]
    amps = _envelope(harm_f, formants, spk["tilt"]) * (harm_f < 0.48 * SR)
    amps *= (voiced * gain)[:, None]
    voiced_sig = np.sum(at(amps, s) * np.sin(phase[:, None] * k[None, :]), axis=1)

    unvoiced_gain = gain * (1.0 - voiced) + 0.03 * voiced * gain
    noise = _shaped_noise(rng, n, lambda i: at(formants, i.astype(np.float64)),
                          lambda i: at(unvoiced_gain, i.astype(np.float64)),
                          spk["tilt"] * 8.0)
    x = voiced_sig + 6.0 * noise + 1e-4 * rng.standard_normal(n)
    return 0.5 * x / np.max(np.abs(x))


def write_corpus(root: str, seed: int = 0, n_pairs: int = 8,
                 min_s: float = 2.5, max_s: float = 4.5) -> str:
    """Write the SF1 → TF1 parallel corpus under ``root``; return
    ``<root>/data``. A corpus already written with the same parameters is
    kept as it is."""
    params = dict(seed=seed, n_pairs=n_pairs, min_s=min_s, max_s=max_s)
    data = os.path.join(root, "data")
    stamp = os.path.join(root, "corpus.json")
    if os.path.isfile(stamp):
        with open(stamp) as f:
            if json.load(f) == params:
                return data
    length_rng = np.random.default_rng([seed, 0])
    utts = [f"{100001 + i}" for i in range(n_pairs)] + [HELD_OUT_UTT]
    seconds = length_rng.uniform(min_s, max_s, len(utts))
    for spk in SPEAKERS:
        os.makedirs(os.path.join(data, spk), exist_ok=True)
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    for utt, sec in zip(utts, seconds):
        for spk in SPEAKERS:
            x = render_utterance(seed, utt, spk, float(sec), (min_s, max_s))
            path = (os.path.join(root, "wav", f"{spk}_{utt}.wav")
                    if utt == HELD_OUT_UTT
                    else os.path.join(data, spk, f"{utt}.wav"))
            write_wav(path, x, SR)
    with open(stamp, "w") as f:
        json.dump(params, f)
    return data


def bench_data() -> str:
    """The ``data/`` root a benchmark reads: ``EVC_BENCH_DATA`` when set,
    else the seed-0 corpus, written once at ``<checkout>/corpus/seed0``
    (listed in ``.gitignore``)."""
    env = os.environ.get("EVC_BENCH_DATA")
    if env:
        return env
    checkout = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return write_corpus(os.path.join(checkout, "corpus", "seed0"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="corpus root directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pairs", type=int, default=8, help="training pairs")
    ap.add_argument("--min-s", type=float, default=2.5)
    ap.add_argument("--max-s", type=float, default=4.5)
    args = ap.parse_args(argv)
    print(write_corpus(args.out, seed=args.seed, n_pairs=args.pairs,
                       min_s=args.min_s, max_s=args.max_s))


if __name__ == "__main__":
    main()

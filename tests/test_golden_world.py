"""Golden parity: world/ vs float64 oracles of WORLD's algorithms.

pyworld cannot install in this image (PARITY.md records the evidence); the
oracles in tests/oracles/ are standalone float64 ports of the published
WORLD algorithms. These tests fail if world/cheaptrick.py drifts from the
reference algorithm (``pw.cheaptrick`` at ``03_a_b_r_parallel.py:94``).
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from exemplars_vc_tpu.world.cheaptrick import cheaptrick, world_fft_size
from tests.oracles.make_goldens import W_FFT, W_HOP_MS, WORLD_UTTS

GOLDENS = os.path.join(
    os.path.dirname(__file__), "goldens", "world_cheaptrick_oracle.npz"
)
REF_DATA = "/root/reference/data"


@pytest.fixture(scope="module")
def goldens():
    if not os.path.isdir(REF_DATA):
        pytest.skip("reference data not available")
    return np.load(GOLDENS)


def _lsd_db(a, b):
    return np.sqrt(
        np.mean((10 * np.log10(a + 1e-30) - 10 * np.log10(b + 1e-30)) ** 2, axis=-1)
    )


def test_world_default_fft_size():
    # WORLD: 2^(1+floor(log2(3*fs/f0_floor+1))) = 1024 for fs=16k, floor=71
    assert world_fft_size(16000, 71.0) == 1024


def test_cheaptrick_matches_world_oracle(goldens):
    """Log-spectral distortion vs the float64 WORLD oracle <= 0.1 dB on every
    golden frame of every utterance (measured headroom ~0.0004 dB max)."""
    from exemplars_vc_tpu.io import read_wav

    for spk, name in WORLD_UTTS:
        key = f"{spk}_{name}"
        x, sr = read_wav(os.path.join(REF_DATA, spk, name + ".wav"))
        f0 = goldens[f"{key}_f0"]
        sel = goldens[f"{key}_sel"]
        hop = int(round(sr * W_HOP_MS / 1000.0))
        centers = np.arange(len(f0)) * hop
        env = np.asarray(
            cheaptrick(
                jnp.asarray(x, jnp.float32), jnp.asarray(f0, jnp.float32),
                jnp.asarray(centers), sr=sr, fft_size=W_FFT,
            )
        )[sel]
        lsd = _lsd_db(env, goldens[f"{key}_sp"].astype(np.float64))
        assert lsd.max() <= 0.1, f"{key}: max LSD {lsd.max():.4f} dB"


def test_cheaptrick_golden_reproducible(goldens):
    """Re-running the float64 oracle on a few frames reproduces the stored
    golden (deterministic float64 numpy)."""
    from exemplars_vc_tpu.io import read_wav
    from tests.oracles.world_cheaptrick import cheaptrick_oracle

    spk, name = WORLD_UTTS[0]
    key = f"{spk}_{name}"
    x, sr = read_wav(os.path.join(REF_DATA, spk, name + ".wav"))
    f0 = goldens[f"{key}_f0"]
    sel = goldens[f"{key}_sel"][:3]
    hop = int(round(sr * W_HOP_MS / 1000.0))
    env = cheaptrick_oracle(
        np.asarray(x, np.float64), sr, f0[sel], sel * hop / sr, fft_size=W_FFT
    )
    np.testing.assert_allclose(
        env.astype(np.float32), goldens[f"{key}_sp"][:3], rtol=1e-6, atol=0
    )


D4C_GOLDENS = os.path.join(
    os.path.dirname(__file__), "goldens", "world_d4c_oracle.npz"
)


def test_d4c_matches_world_oracle(goldens):
    """Aperiodicity in dB vs the float64 D4C oracle within 0.5 dB on every
    golden frame (measured headroom ~0.0004 dB; the gate leaves room for
    voiced/unvoiced flips at the LoveTrain threshold on other platforms)."""
    from exemplars_vc_tpu.io import read_wav
    from exemplars_vc_tpu.world.d4c import d4c_aperiodicity

    d4c_gold = np.load(D4C_GOLDENS)
    for spk, name in WORLD_UTTS:
        key = f"{spk}_{name}"
        x, sr = read_wav(os.path.join(REF_DATA, spk, name + ".wav"))
        f0 = goldens[f"{key}_f0"]
        sel = goldens[f"{key}_sel"]
        hop = int(round(sr * W_HOP_MS / 1000.0))
        centers = np.arange(len(f0)) * hop
        ap = np.asarray(
            d4c_aperiodicity(
                jnp.asarray(x, jnp.float32), jnp.asarray(f0, jnp.float32),
                jnp.asarray(centers), sr=sr, fft_size=W_FFT,
            )
        )[sel]
        ref = d4c_gold[f"{key}_ap"].astype(np.float64)
        d_db = np.abs(20 * np.log10(ap + 1e-12) - 20 * np.log10(ref + 1e-12))
        assert d_db.max() <= 0.5, f"{key}: max ap diff {d_db.max():.4f} dB"


def test_d4c_known_hnr_quantitative():
    """Quantitative aperiodicity on synthetic harmonic+noise mixes at known
    HNRs: the estimated band aperiodicity must decrease
    monotonically with HNR and land near sqrt(noise/total)."""
    from exemplars_vc_tpu.world.d4c import d4c_aperiodicity

    sr, f0v = 16000, 200.0
    t = np.arange(int(sr * 0.6)) / sr
    rng = np.random.default_rng(0)
    harm = np.zeros_like(t)
    for k in range(1, 36):                       # 1/k rolloff like speech —
        if k * f0v < 7800:                       # flat spectra fail LoveTrain
            harm += np.sin(2 * np.pi * k * f0v * t + rng.uniform(0, 6)) / k
    harm /= np.sqrt(np.mean(harm**2))
    noise = rng.standard_normal(len(t))
    noise /= np.sqrt(np.mean(noise**2))

    n_frames = len(t) // 80
    centers = jnp.arange(n_frames) * 80
    f0 = jnp.full((n_frames,), f0v, jnp.float32)

    # band-local component energies → physically expected sqrt(noise/total)
    freqs = np.fft.rfftfreq(len(t), 1 / sr)
    band_sel = (freqs > 2300) & (freqs < 3600)
    ph = np.sum(np.abs(np.fft.rfft(harm))[band_sel] ** 2)
    pn = np.sum(np.abs(np.fft.rfft(noise))[band_sel] ** 2)

    measured = []
    for hnr_db in (20.0, 10.0, 0.0):
        g = 10.0 ** (-hnr_db / 20.0)
        x = jnp.asarray(harm + g * noise, jnp.float32)
        ap = np.asarray(d4c_aperiodicity(x, f0, centers, sr=sr, fft_size=1024))
        band = ap[5:-5, 150:230]                 # ~2.3-3.6 kHz (3 kHz band)
        measured.append(float(np.median(band)))
        expected = np.sqrt(g * g * pn / (ph + g * g * pn))
        # within a factor ~2.5 in amplitude of the physical band ratio
        assert expected / 2.5 < measured[-1] < min(1.0, expected * 2.5), (
            hnr_db, measured[-1], expected
        )
    assert measured[0] < measured[1] < measured[2]


def test_cheaptrick_unvoiced_uses_default_f0(goldens):
    """WORLD semantics: f0 <= floor (incl. unvoiced 0) analyzes at
    kDefaultF0 = 500 Hz — envelope equals an explicit 500 Hz call."""
    from exemplars_vc_tpu.io import read_wav

    spk, name = WORLD_UTTS[0]
    x, sr = read_wav(os.path.join(REF_DATA, spk, name + ".wav"))
    xj = jnp.asarray(x, jnp.float32)
    centers = jnp.asarray(np.arange(10) * 80 + 8000)
    e0 = np.asarray(cheaptrick(xj, jnp.zeros(10), centers, sr=sr, fft_size=W_FFT))
    e500 = np.asarray(
        cheaptrick(xj, jnp.full(10, 500.0), centers, sr=sr, fft_size=W_FFT)
    )
    np.testing.assert_allclose(e0, e500, rtol=1e-6)

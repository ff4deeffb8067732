import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exemplars_vc_tpu.world import (
    analyze,
    cheaptrick,
    d4c_aperiodicity,
    estimate_f0,
    refine_f0_stonemask,
    synthesize,
)


def _voiced_signal(f0_hz=140.0, sr=16000, seconds=1.0, n_harm=12, seed=0):
    """Pulse-train-like harmonic signal with formant envelope."""
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.default_rng(seed)
    y = np.zeros_like(t)
    for k in range(1, n_harm + 1):
        f = k * f0_hz
        amp = 1.0 / (1 + ((f - 600) / 500) ** 2) + 0.5 / (1 + ((f - 1800) / 500) ** 2)
        y += amp * np.cos(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    return (0.3 * y / np.abs(y).max()).astype(np.float32)


def test_f0_estimation_pure_tone_complex():
    sr = 16000
    for true_f0 in [110.0, 220.0, 330.0]:
        x = _voiced_signal(true_f0, sr=sr, seconds=0.7, seed=int(true_f0))
        f0, voiced = estimate_f0(jnp.asarray(x), sr=sr)
        f0 = np.asarray(f0)
        v = np.asarray(voiced)
        # interior frames must be voiced with f0 within 5%
        interior = slice(10, len(f0) - 10)
        assert v[interior].mean() > 0.9
        est = np.median(f0[interior][v[interior]])
        assert abs(est - true_f0) / true_f0 < 0.05, (true_f0, est)


def test_f0_silence_is_unvoiced():
    x = jnp.zeros(8000)
    f0, voiced = estimate_f0(x)
    assert not bool(voiced.any())
    assert float(jnp.abs(f0).max()) == 0.0


def test_stonemask_refines():
    sr = 16000
    true_f0 = 173.3
    x = _voiced_signal(true_f0, sr=sr, seconds=0.7)
    f0, voiced = estimate_f0(jnp.asarray(x), sr=sr)
    refined = refine_f0_stonemask(jnp.asarray(x), f0, sr=sr)
    f0n, rn = np.asarray(f0), np.asarray(refined)
    v = np.asarray(voiced)
    interior = slice(10, len(f0n) - 10)
    err_raw = np.abs(f0n[interior][v[interior]] - true_f0).mean()
    err_ref = np.abs(rn[interior][v[interior]] - true_f0).mean()
    assert err_ref <= err_raw + 0.3
    assert err_ref / true_f0 < 0.02


def test_cheaptrick_envelope_tracks_formants():
    sr = 16000
    x = _voiced_signal(150.0, sr=sr, seconds=0.7)
    xj = jnp.asarray(x)
    f0, _ = estimate_f0(xj, sr=sr)
    centers = jnp.arange(f0.shape[0]) * 80
    sp = cheaptrick(xj, f0, centers, sr=sr, fft_size=1024)
    assert sp.shape == (f0.shape[0], 513)
    assert bool(jnp.isfinite(sp).all()) and bool((sp > 0).all())
    env = np.asarray(sp)[40]  # a mid frame
    freqs = np.arange(513) * sr / 1024
    # envelope at the 600 Hz formant should dominate a 3.5 kHz valley
    peak = env[(freqs > 400) & (freqs < 800)].max()
    valley = env[(freqs > 3200) & (freqs < 4000)].max()
    assert peak > 5 * valley


def test_d4c_voiced_lower_than_unvoiced():
    sr = 16000
    x_v = _voiced_signal(150.0, sr=sr, seconds=0.5)
    rng = np.random.default_rng(0)
    x_n = (0.1 * rng.standard_normal(len(x_v))).astype(np.float32)
    xj = jnp.asarray(np.concatenate([x_v, x_n]))
    f0, _ = estimate_f0(xj, sr=sr)
    centers = jnp.arange(f0.shape[0]) * 80
    ap = d4c_aperiodicity(xj, f0, centers, sr=sr)
    apn = np.asarray(ap)
    F = len(x_v) // 80
    # aperiodicity is only meaningful where the signal has energy: the test
    # tone's harmonics live below 1.8 kHz
    freqs = np.arange(apn.shape[1]) * sr / 1024
    band = freqs < 1800
    ap_voiced = apn[10 : F - 10][:, band].mean()
    ap_noise = apn[F + 10 : -10][:, band].mean()
    assert ap_voiced < 0.3, ap_voiced
    assert ap_noise > 0.9, ap_noise
    assert ((apn > 0) & (apn < 1)).all()


def test_synthesis_analyzer_consistent_envelope():
    """Quantitative envelope round trip: synthesizing
    from known steady (f0, sp, ap) and re-analyzing must return the same
    envelope — mid-band bias < 1 dB, rms < 2 dB (measured ≈0.2 / 0.6 dB;
    the harmonic gain is calibrated to THIS framework's CheapTrick, see
    world/synthesis.py)."""
    sr = 16000
    F, B = 200, 513
    freqs = np.arange(B) * sr / 1024
    env = (1e3 * np.exp(-(((freqs - 700) / 400) ** 2))
           + 3e2 * np.exp(-(((freqs - 2400) / 600) ** 2)) + 1.0)
    sp = np.tile(env.astype(np.float32), (F, 1))
    ap = np.full((F, B), 0.1, np.float32)
    f0 = np.full(F, 200.0, np.float32)
    y = synthesize(jnp.asarray(f0), jnp.asarray(sp), jnp.asarray(ap), sr=sr)
    b = analyze(y, sr=sr)
    n = min(F, len(b.f0))
    interior = slice(10, n - 10)
    spb = np.asarray(b.sp)[interior]
    d = (10 * np.log10(np.maximum(spb, 1e-12))
         - 10 * np.log10(sp[interior]))
    # mid bands (500 Hz – 7 kHz): exclude the DC edge and the Nyquist band
    # where D4C's WORLD-convention 0 dB pin replaces harmonics with noise
    mid = slice(32, 448)
    bias = d[:, mid].mean()
    rms = np.sqrt((d[:, mid] ** 2).mean())
    assert abs(bias) < 1.0, bias
    assert rms < 2.0, rms


def test_analysis_synthesis_roundtrip():
    sr = 16000
    x = _voiced_signal(150.0, sr=sr, seconds=0.8)
    feats = analyze(jnp.asarray(x), sr=sr)
    y = synthesize(feats.f0, feats.sp, feats.ap, sr=sr)
    y = np.asarray(y)
    assert np.isfinite(y).all()
    n = min(len(x), len(y))
    # energy within 6 dB and f0 of resynthesis matches
    rms_x = np.sqrt(np.mean(x[:n] ** 2))
    rms_y = np.sqrt(np.mean(y[:n] ** 2))
    assert 0.25 < rms_y / rms_x < 4.0, (rms_x, rms_y)
    f0_y, voiced_y = estimate_f0(jnp.asarray(y), sr=sr)
    v = np.asarray(voiced_y)
    assert v[10:-10].mean() > 0.7
    est = np.median(np.asarray(f0_y)[10:-10][v[10:-10]])
    assert abs(est - 150.0) / 150.0 < 0.05


def test_analysis_on_real_audio(sf1_wav):
    x, sr = sf1_wav
    xj = jnp.asarray(x[: 2 * sr], jnp.float32)
    feats = analyze(xj, sr=sr)
    f0 = np.asarray(feats.f0)
    assert (f0 >= 0).all()
    voiced_frac = (f0 > 0).mean()
    assert 0.1 < voiced_frac < 0.95  # real speech has voiced and unvoiced parts
    # female speaker SF1: median voiced f0 in a plausible range
    med = np.median(f0[f0 > 0])
    assert 120 < med < 350, med
    assert bool(jnp.isfinite(feats.sp).all())
    assert bool(jnp.isfinite(feats.ap).all())


def test_tracked_f0_matches_on_clean_tone():
    from exemplars_vc_tpu.world.f0 import estimate_f0_tracked

    sr = 16000
    x = _voiced_signal(200.0, sr=sr, seconds=0.7)
    f0, v = estimate_f0_tracked(jnp.asarray(x), sr=sr)
    f0n, vn = np.asarray(f0), np.asarray(v)
    interior = slice(10, len(f0n) - 10)
    assert vn[interior].mean() > 0.9
    est = np.median(f0n[interior][vn[interior]])
    assert abs(est - 200.0) / 200.0 < 0.05, est


def test_tracked_f0_rejects_octave_jumps():
    """A corrupted mid-region must not drag the contour to an octave error:
    the Viterbi transition cost keeps continuity where greedy picking flips."""
    from exemplars_vc_tpu.world.f0 import estimate_f0_tracked

    sr = 16000
    x = _voiced_signal(180.0, sr=sr, seconds=0.9)
    rng = np.random.default_rng(0)
    x = x + 0.08 * rng.standard_normal(len(x)).astype(np.float32)  # noise
    f0, v = estimate_f0_tracked(jnp.asarray(x), sr=sr)
    f0n, vn = np.asarray(f0), np.asarray(v)
    good = f0n[vn]
    assert len(good) > 20
    # no voiced frame may sit at the half/double octave of the median
    med = np.median(good)
    assert abs(med - 180.0) / 180.0 < 0.06
    octave_frac = np.mean((np.abs(good - med / 2) < 10) | (np.abs(good - med * 2) < 20))
    assert octave_frac < 0.05, octave_frac


def test_tracked_f0_silence_unvoiced():
    from exemplars_vc_tpu.world.f0 import estimate_f0_tracked

    f0, v = estimate_f0_tracked(jnp.zeros(8000))
    assert not bool(v.any())

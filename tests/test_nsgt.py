"""NSGT (matrix-form nonstationary Gabor / invertible CQT) and the long-signal
complex FFT behind it.

Covers the capability of the reference's vendored pyfasst nsgt package
(dependencies/pyfasst-master/pyfasst/tftransforms/nsgt/): window construction
with canonical duals, forward/inverse transform, perfect reconstruction.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from exemplars_vc_tpu.dsp import fft as F
from exemplars_vc_tpu.dsp.nsgt import insgt, nsgt, nsgt_plan


# ---------------------------------------------------------------- complex FFT

@pytest.mark.parametrize("n", [60, 128, 300, 2048, 3000, 4352])
def test_fft_matches_numpy(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))).astype(np.complex64)
    got = np.asarray(F.fft(jnp.asarray(x)))
    ref = np.fft.fft(x, axis=-1)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.real, ref.real, atol=5e-4 * scale)
    np.testing.assert_allclose(got.imag, ref.imag, atol=5e-4 * scale)


def test_fft_real_input_and_prime_length():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 127)).astype(np.float32)  # prime → direct DFT
    got = np.asarray(F.fft(jnp.asarray(x)))
    ref = np.fft.fft(x, axis=-1)
    np.testing.assert_allclose(got, ref, atol=3e-4 * np.abs(ref).max())


def test_ifft_roundtrip():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 3000)) + 1j * rng.standard_normal((2, 3000))).astype(np.complex64)
    back = np.asarray(F.ifft(F.fft(jnp.asarray(x))))
    np.testing.assert_allclose(back, x, atol=2e-3)


def test_fft_pad_and_native_parity():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 250)).astype(np.float32)
    got = np.asarray(F.fft(jnp.asarray(x), n=300))
    ref = np.fft.fft(x, n=300, axis=-1)
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


# ----------------------------------------------------------------------- NSGT

def test_plan_shapes_and_m_divides_l():
    p = nsgt_plan(16000, 3000, fmin=100.0, bins_per_octave=12)
    assert p.L % 256 == 0 and p.L >= 3000
    assert p.L % p.M == 0
    assert p.n_bands == 2 * p.n_pos + 2
    assert p.idx.shape == p.win.shape == p.dual.shape == p.pos.shape
    assert p.freqs[0] == 0.0 and p.freqs[p.n_pos + 1] == 8000.0


def test_perfect_reconstruction():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(3000).astype(np.float32)
    c = nsgt(jnp.asarray(x), sr=16000, fmin=100.0)
    back = np.asarray(insgt(c, 3000, sr=16000, fmin=100.0))
    np.testing.assert_allclose(back, x, atol=5e-4 * np.abs(x).max())


def test_perfect_reconstruction_batched_matmul_path():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 2800)).astype(np.float32)
    c = nsgt(jnp.asarray(x), sr=16000, fmin=120.0, bins_per_octave=8)
    assert c.shape[:2] == (2, nsgt_plan(16000, 2800, 120.0, 8).n_bands)
    back = np.asarray(insgt(c, 2800, sr=16000, fmin=120.0, bins_per_octave=8))
    np.testing.assert_allclose(back, x, atol=2e-3)


def test_tone_lands_in_matching_band():
    sr, Ls, f0 = 16000, 4000, 880.0
    t = np.arange(Ls) / sr
    x = np.sin(2 * np.pi * f0 * t).astype(np.float32)
    p = nsgt_plan(sr, Ls, fmin=100.0, bins_per_octave=12)
    mag = np.abs(np.asarray(nsgt(jnp.asarray(x), sr=sr, fmin=100.0)))
    # strongest positive-frequency band should be the one nearest 880 Hz
    band_energy = mag[1 : p.n_pos + 1].sum(axis=-1)
    expect = np.argmin(np.abs(p.freqs[1 : p.n_pos + 1] - f0))
    assert abs(int(np.argmax(band_energy)) - int(expect)) <= 1


def test_constant_q_band_supports_scale_with_frequency():
    p = nsgt_plan(16000, 8000, fmin=100.0, bins_per_octave=12)
    lens = (p.win > 0).sum(axis=1)[1 : p.n_pos + 1]
    # supports grow roughly geometrically with center frequency (constant Q)
    assert lens[-1] > 4 * lens[0]


def test_insgt_rejects_mismatched_coefficients():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(3000).astype(np.float32)
    c = nsgt(jnp.asarray(x), sr=16000, fmin=100.0)
    with pytest.raises(ValueError, match="do not match the plan"):
        insgt(c[..., : c.shape[-1] // 2], 3000, sr=16000, fmin=100.0)
    with pytest.raises(ValueError, match="do not match the plan"):
        insgt(c, 3000, sr=16000, fmin=200.0)  # different plan


def test_nsgt_rejects_complex_input():
    z = jnp.ones(1000, jnp.complex64)
    with pytest.raises(ValueError, match="real signal"):
        nsgt(z)


def test_plan_length_is_smooth():
    # 256·8209 would be a prime multiplier → plan must bump to a 7-smooth one
    p = nsgt_plan(16000, 256 * 8209, fmin=100.0)
    m = p.L // 256
    for q in (2, 3, 5, 7):
        while m % q == 0:
            m //= q
    assert m == 1 and p.L >= 256 * 8209 and p.L % p.M == 0

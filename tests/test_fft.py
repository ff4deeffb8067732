"""The FFT layer (XLA's native FFT on every backend) and the STFT/ISTFT built
on it, against numpy float64 at the pipeline's transform sizes."""

import jax.numpy as jnp
import numpy as np
import pytest

from exemplars_vc_tpu.dsp import fft as F
from exemplars_vc_tpu.dsp import istft, stft

# STFT 400, 512 (WORLD f0 / LPC), 1024 (WORLD fft_size), 2048 (long-window
# analyses) and a long NSGT plan length (256·63, one second at 16 kHz)
SIZES = [400, 512, 1024, 2048, 16128]


def _np_stft(x, n_fft, hop):
    w = np.hanning(n_fft + 1)[:-1]                    # periodic hann
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(n_fft // 2, n_fft // 2)],
                mode="reflect")
    n = (xp.shape[-1] - n_fft) // hop + 1
    idx = np.arange(n)[:, None] * hop + np.arange(n_fft)[None, :]
    return np.fft.rfft(xp[..., idx] * w, axis=-1)


def _np_istft(S, n_fft, hop, length):
    w = np.hanning(n_fft + 1)[:-1]
    frames = np.fft.irfft(S, n=n_fft, axis=-1) * w
    out_len = n_fft + hop * (S.shape[0] - 1)
    y, wsum = np.zeros(out_len), np.zeros(out_len)
    for f in range(S.shape[0]):
        y[f * hop: f * hop + n_fft] += frames[f]
        wsum[f * hop: f * hop + n_fft] += w * w
    y = (y / np.maximum(wsum, 1e-8))[n_fft // 2: out_len - n_fft // 2]
    return y[:length]


def _assert_close(got, ref, rtol=1e-5):
    """Max error relative to the reference's largest magnitude."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got.astype(np.complex128) - ref).max() / np.abs(ref).max()
    assert err <= rtol, err


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", ["rfft", "irfft", "fft", "ifft", "stft", "istft"])
def test_native_transforms_match_numpy(op, n):
    """Each transform at each size, batched over a leading axis."""
    rng = np.random.default_rng(n)
    if op in ("rfft", "fft"):
        x = rng.standard_normal((3, n))
        if op == "fft":
            x = x + 1j * rng.standard_normal((3, n))
        ref = getattr(np.fft, op)(x, axis=-1)
        got = getattr(F, op)(jnp.asarray(x, jnp.complex64 if op == "fft" else jnp.float32))
    elif op in ("irfft", "ifft"):
        bins = n // 2 + 1 if op == "irfft" else n
        X = rng.standard_normal((3, bins)) + 1j * rng.standard_normal((3, bins))
        ref = getattr(np.fft, op)(X, n=n, axis=-1)
        got = getattr(F, op)(jnp.asarray(X, jnp.complex64), n=n)
    elif op == "stft":
        hop = n // 4
        x = rng.standard_normal((2, 3 * n))
        ref = _np_stft(x, n, hop)
        got = stft(jnp.asarray(x, jnp.float32), n_fft=n, hop_length=hop)
    else:
        hop = n // 4
        x = rng.standard_normal(3 * n)
        S = _np_stft(x, n, hop)
        ref = _np_istft(S, n, hop, len(x))
        got = istft(jnp.asarray(S, jnp.complex64), n_fft=n, hop_length=hop,
                    length=len(x))
    _assert_close(got, ref)


@pytest.mark.parametrize("op", ["rfft", "fft"])
@pytest.mark.parametrize("n", [256, 512])
def test_native_transforms_pad_and_truncate(op, n):
    """``n`` shorter or longer than the input truncates or zero-pads."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 400)).astype(np.float32)
    _assert_close(getattr(F, op)(jnp.asarray(x), n=n),
                  getattr(np.fft, op)(x.astype(np.float64), n=n, axis=-1))


def test_rfft_matches_numpy():
    rng = np.random.default_rng(0)
    for n in [400, 512, 1024]:
        x = rng.standard_normal((7, n)).astype(np.float32)
        got = np.asarray(F.rfft(jnp.asarray(x), n=n))
        ref = np.fft.rfft(x, n=n, axis=-1)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got.real, ref.real, atol=2e-4 * scale)
        np.testing.assert_allclose(got.imag, ref.imag, atol=2e-4 * scale)


def test_rfft_pads_and_truncates():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 400)).astype(np.float32)
    got = np.asarray(F.rfft(jnp.asarray(x), n=512))
    ref = np.fft.rfft(x, n=512, axis=-1)
    np.testing.assert_allclose(got, ref, atol=2e-3)
    got2 = np.asarray(F.rfft(jnp.asarray(x), n=256))
    ref2 = np.fft.rfft(x[:, :256], n=256, axis=-1)
    np.testing.assert_allclose(got2, ref2, atol=2e-3)


def test_irfft_matches_numpy():
    rng = np.random.default_rng(2)
    for n in [400, 512]:
        X = (rng.standard_normal((5, n // 2 + 1)) + 1j * rng.standard_normal((5, n // 2 + 1))).astype(np.complex64)
        got = np.asarray(F.irfft(jnp.asarray(X), n=n))
        ref = np.fft.irfft(X, n=n, axis=-1)
        np.testing.assert_allclose(got, ref, atol=3e-4 * np.abs(X).max())


def test_irfft_of_real_input():
    rng = np.random.default_rng(3)
    X = np.abs(rng.standard_normal((4, 257))).astype(np.float32)  # power spectrum
    got = np.asarray(F.irfft(jnp.asarray(X), n=512))
    ref = np.fft.irfft(X, n=512, axis=-1)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_roundtrip():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 512)).astype(np.float32)
    back = np.asarray(F.irfft(F.rfft(jnp.asarray(x), n=512), n=512))
    np.testing.assert_allclose(back, x, atol=1e-5)


def test_rfft_magsq():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 400)).astype(np.float32)
    got = np.asarray(F.rfft_magsq(jnp.asarray(x), n=512))
    ref = np.abs(np.fft.rfft(x, n=512, axis=-1)) ** 2
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5 * ref.max())


def test_conv_ola_matches_scatter():
    from exemplars_vc_tpu.dsp.stft import _ola_conv

    rng = np.random.default_rng(13)
    frames = rng.standard_normal((30, 400)).astype(np.float32)
    got = np.asarray(_ola_conv(jnp.asarray(frames), 80))
    out_len = 400 + 80 * 29
    ref = np.zeros(out_len, np.float32)
    for f in range(30):
        ref[f * 80 : f * 80 + 400] += frames[f]
    np.testing.assert_allclose(got, ref, atol=1e-4)

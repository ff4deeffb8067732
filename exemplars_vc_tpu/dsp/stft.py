"""Framing, STFT and ISTFT as jitted JAX ops with static shapes.

Replaces librosa/numpy STFT use in the reference:
- ``librosa.core.stft(n_fft=400, hop_length=80, window='hann')`` feature path
  (``03_a_b_r_parallel.py:101-105``, ``04_align_n_nmf.py:422``)
- ``librosa.util.frame(frame_length=400, hop_length=80)`` mcep framing
  (``01_make_dict_parallel.py:126``)
- the hand-rolled reconstruction stft/istft (``zz_audio_utilities.py:181-218``)

Design: framing is one strided gather and the FFT is XLA's native one
(``exemplars_vc_tpu.dsp.fft``). ISTFT does window-sum–normalized overlap-add
(mathematically exact under NOLA, unlike the reference's unnormalized
overlap-add), implemented as an r-tap transposed convolution over the frame
axis (r = n_fft/hop contributing frames per sample) — a single dense op with
static shapes in place of a scatter-add, numerically identical.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from exemplars_vc_tpu.dsp import fft as _fft

from exemplars_vc_tpu.dsp.windows import get_window


@partial(jax.jit, static_argnames=("frame_length", "hop_length"))
def frame_signal(x: jnp.ndarray, frame_length: int, hop_length: int) -> jnp.ndarray:
    """(T,) -> (n_frames, frame_length), no padding (librosa.util.frame).

    One strided gather."""
    n = (x.shape[-1] - frame_length) // hop_length + 1
    idx = jnp.arange(n)[:, None] * hop_length + jnp.arange(frame_length)[None, :]
    return x[..., idx]


@partial(
    jax.jit,
    static_argnames=("n_fft", "hop_length", "window", "center", "pad_mode"),
)
def stft(
    x: jnp.ndarray,
    n_fft: int = 400,
    hop_length: int = 80,
    window: str = "hann",
    center: bool = True,
    pad_mode: str = "reflect",
) -> jnp.ndarray:
    """STFT of a (possibly batched) signal → (..., n_frames, n_fft//2+1) complex.

    ``center=True`` + periodic hann + reflect padding matches the librosa
    defaults the reference was built against. Frame axis is time-major (the
    reference immediately transposes librosa's output to frames-major —
    ``03_a_b_r_parallel.py:103``)."""
    if center:
        pad = [(0, 0)] * (x.ndim - 1) + [(n_fft // 2, n_fft // 2)]
        x = jnp.pad(x, pad, mode=pad_mode)
    w = get_window(window, n_fft, periodic=True, dtype=x.dtype)
    frames = frame_signal(x, n_fft, hop_length)
    return _fft.rfft(frames * w, n=n_fft)


def stft_magnitude(x: jnp.ndarray, **kw) -> jnp.ndarray:
    return jnp.abs(stft(x, **kw))


def _ola_conv(frames: jnp.ndarray, hop: int) -> jnp.ndarray:
    """(F, n_fft) frames → (n_fft + hop·(F−1),) overlap-add as a tiny conv.

    When hop divides n_fft (r = n_fft/hop), view each frame as r hop-chunks;
    the output row q (of hop samples) is Σ_k chunks[q−k, k] — a depthwise
    r-tap convolution along the frame axis with a flipped-identity r×r
    kernel (r=5 for the 400/80 default: ~1 MFLOP, vs 9 GFLOP for the dense
    identity-kernel transposed conv)."""
    n_frames, n_fft = frames.shape
    if n_fft % hop == 0:
        r = n_fft // hop
        chunks = frames.reshape(n_frames, r, hop)
        lhs = jnp.moveaxis(chunks, 2, 0).transpose(0, 2, 1)  # (hop, r, F)
        eye = jnp.eye(r, dtype=frames.dtype)[:, ::-1]        # flipped identity
        kernel = eye[None, :, :]                             # (O=1, I=r, r)
        out = jax.lax.conv_general_dilated(
            lhs, kernel, window_strides=(1,),
            padding=[(r - 1, r - 1)],
            dimension_numbers=("NCH", "OIH", "NCH"),
        )                                                    # (hop, 1, F+r-1)
        return out[:, 0, :].T.reshape(-1)                    # (F+r-1, hop) → flat
    # general hop: dense transposed conv with an identity kernel
    lhs = frames.T[None, :, :]                               # (1, C=n_fft, F)
    eye = jnp.eye(n_fft, dtype=frames.dtype)[:, ::-1]
    kernel = eye[None, :, :]                                 # (O=1, I=n_fft, n_fft)
    out = jax.lax.conv_general_dilated(
        lhs, kernel, window_strides=(1,),
        padding=[(n_fft - 1, n_fft - 1)],
        lhs_dilation=(hop,),
        dimension_numbers=("NCH", "OIH", "NCH"),
    )
    return out[0, 0, :]


@partial(
    jax.jit,
    static_argnames=("n_fft", "hop_length", "window", "center", "length"),
)
def istft(
    spec: jnp.ndarray,
    n_fft: int = 400,
    hop_length: int = 80,
    window: str = "hann",
    center: bool = True,
    length: int | None = None,
) -> jnp.ndarray:
    """Inverse STFT with window-sum normalization (exact NOLA inverse).

    spec: (n_frames, n_fft//2+1) complex, frames-major."""
    w = get_window(window, n_fft, periodic=True, dtype=jnp.float32)
    frames = _fft.irfft(spec, n=n_fft).astype(jnp.float32) * w

    n_frames = spec.shape[-2]
    out_len = n_fft + hop_length * (n_frames - 1)

    # overlap-add as a fractionally-strided (transposed) convolution with a
    # flipped-identity kernel: y[τ] = Σ_f frames[f, τ − f·hop]
    y = _ola_conv(frames, hop_length)
    wsum = _ola_conv(
        jnp.broadcast_to(w * w, (n_frames, n_fft)), hop_length
    )
    y = y / jnp.maximum(wsum, 1e-8)

    if center:
        y = y[n_fft // 2 : out_len - n_fft // 2]
    if length is not None:
        if y.shape[0] < length:  # librosa semantics: zero-pad the tail
            y = jnp.pad(y, (0, length - y.shape[0]))
        y = y[:length]
    return y

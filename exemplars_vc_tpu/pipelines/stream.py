"""Streaming conversion: low-latency chunked exemplar VC.

New capability beyond the reference (which is strictly batch): convert audio
in fixed-size frame chunks as they arrive.

Why this is exact for the decomposition: with a FIXED dictionary, the MU
update for activation row f uses only X[f] and A — rows are independent — so
solving chunk-by-chunk reaches the same per-frame fixed point as the batch
solve. Only synthesis needs temporal context: Griffin-Lim runs on the chunk
plus a left-context of already-converted frames, and only the new region is
emitted (overlap-save), which keeps phase coherent across seams.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from exemplars_vc_tpu.config import Config
from exemplars_vc_tpu.dsp import griffin_lim
from exemplars_vc_tpu.factorize import convert_features
from exemplars_vc_tpu.pipelines.convert import _solve_activations


class StreamingConverter:
    """Push frame chunks of |STFT| magnitudes, receive audio chunks.

    >>> sc = StreamingConverter(cfg, A, B, context_frames=32)
    >>> audio = sc.push(mag_chunk)       # (chunk·hop,) samples per push
    >>> tail = sc.flush()
    """

    def __init__(
        self,
        cfg: Config,
        A: np.ndarray,
        B: np.ndarray,
        context_frames: int = 32,
        synth_iters: int = 60,
    ):
        # streaming's contract is chunked ≡ batch conversion (exact by NMF
        # row independence) — that requires the deterministic f32 solve AND
        # no cross-frame coupling in the solve: nmf.context_frames (context
        # stacks neighbor frames, so chunk edges would clamp differently
        # from the batch solve) and nmf.h_smooth (temporal box filter on H)
        # are both force-zeroed here to keep the contract. The row-
        # independent refinements (prune_topk, activation_power,
        # solve_domain) are chunk-safe and pass through.
        if (cfg.nmf.work_dtype != "float32" or cfg.nmf.context_frames != 0
                or cfg.nmf.h_smooth != 0):
            from dataclasses import replace

            cfg = replace(cfg, nmf=replace(
                cfg.nmf, work_dtype="float32", context_frames=0, h_smooth=0))
        self.cfg = cfg
        self.A = jnp.asarray(A, jnp.float32)
        self.B = jnp.asarray(B, jnp.float32)
        self.context_frames = context_frames
        self.synth_iters = synth_iters
        self._context_mag: jnp.ndarray | None = None  # converted left context (device)
        self._context_phase: jnp.ndarray | None = None  # converged phase seed

    def _convert_block(self, X: np.ndarray) -> jnp.ndarray:
        """Converted magnitude for a chunk — DEVICE-resident: synthesis
        consumes it directly, so a push pays exactly one device→host
        transfer (the audio); each avoided round trip is chunk latency saved."""
        st = _solve_activations(jnp.asarray(X, jnp.float32), self.A, self.cfg)
        return convert_features(st.H, self.B)

    def _synthesize(self, mag_new, phase_new=None) -> np.ndarray:
        m = self.cfg.mcep
        hop = m.hop_length
        mag_new = jnp.asarray(mag_new, jnp.float32)
        if self._context_mag is None:
            full = mag_new
            skip = 0
        else:
            full = jnp.concatenate([self._context_mag, mag_new], axis=0)
            skip = int(self._context_mag.shape[0])
        init_phase = None
        if phase_new is not None:
            # seed GL with the incoming chunk's own phase (see dsp.griffin_lim:
            # real speech phase converges far closer at a small iteration
            # budget — exactly the low-latency regime streaming lives in);
            # context frames reuse the previous chunk's CONVERGED phase
            # (returned by griffin_lim below), falling back to unit phase
            ph = jnp.asarray(phase_new)
            if skip:
                ctx_ph = self._context_phase
                if ctx_ph is None or ctx_ph.shape[0] != skip:
                    # context length changed since the phase was stored (it
                    # grows over the first pushes / an unseeded push reset it)
                    ctx_ph = jnp.ones((skip, ph.shape[1]), jnp.complex64)
                ph = jnp.concatenate([ctx_ph, ph], axis=0)
            init_phase = ph
        y_full, final_phase = griffin_lim(
            full, n_fft=m.frame_length,
            hop_length=hop, n_iter=self.synth_iters,
            length=full.shape[0] * hop, init_phase=init_phase,
            return_phase=True,
        )
        y = np.asarray(y_full)
        ctx = self.context_frames
        if ctx <= 0:
            self._context_mag = None
            self._context_phase = None
        else:
            self._context_mag = full[-ctx:] if full.shape[0] >= ctx else full
            if init_phase is not None:
                self._context_phase = final_phase[-self._context_mag.shape[0]:]
            else:
                # mag context updated without a matching phase: a stale seed
                # would misalign (or shape-clash) with the new context frames
                self._context_phase = None
        # emit only the samples belonging to the new frames
        return y[skip * hop : (skip + mag_new.shape[0]) * hop]

    def push(self, mag_chunk: np.ndarray, phase_chunk=None) -> np.ndarray:
        """(F_c, n_bins) converted → audio samples for those frames.

        ``phase_chunk``: optional complex STFT (or unit-phase) of the SOURCE
        chunk on the same frame grid — seeds Griffin-Lim with real speech
        phase instead of white noise (keep it a device array; this backend
        cannot move complex64 to host)."""
        converted = self._convert_block(mag_chunk)
        return self._synthesize(converted, phase_chunk)

    def flush(self) -> np.ndarray:
        """Nothing is buffered beyond context; provided for API symmetry."""
        return np.zeros(0, dtype=np.float32)

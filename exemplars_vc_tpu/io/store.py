"""Speaker datasets, padded batching, and the resumable artifact store.

Replaces the reference's ad-hoc pickle/npy memoization (``utils.py:95-215``,
``01_make_dict_parallel.py:161-177``, ``03_a_b_r_parallel.py:124-126``) — which
doubles as its crash-recovery mechanism (SURVEY §5.3/§5.4) — with one typed
store. Ragged utterances become fixed-shape padded+masked batches so every
downstream stage (DTW, NMF, synthesis) runs under jit with static shapes.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass

import numpy as np

from exemplars_vc_tpu.io.wav import read_wav


def list_speaker_wavs(data_path: str, speaker: str) -> list[str]:
    d = os.path.join(data_path, speaker)
    return [os.path.join(d, n) for n in sorted(os.listdir(d)) if n.lower().endswith(".wav")]


# in-process decode cache: one conversion loads each speaker from several
# stages (dictionary build + conversion features); decoding the same wavs
# repeatedly is pure waste. Keyed by the exact path list; bounded.
_SPEAKER_CACHE: dict[tuple[str, ...], tuple[list[np.ndarray], int]] = {}
_SPEAKER_CACHE_MAX = 8

# device-resident stacked-signal cache: the corpus audio is immutable within
# a process, so the padded (N, T) float32 batch — and its host→device upload
# (~4.6 MB/speaker) — is paid once per (speaker, bucket) instead of once per
# dictionary build. Keyed by the exact
# path list + padding step; bounded.
_STACKED_CACHE: dict = {}
_STACKED_CACHE_MAX = 8


def stacked_speaker_batch(
    data_path: str,
    speaker: str,
    nb_file: int | None,
    step: int,
    cpu_rate: float = 0.6,
):
    """Padded per-speaker signal batch as a DEVICE array.

    Returns (batch (N, T) float32 jnp array with T a multiple of ``step``,
    sample_lengths (N,) int64 numpy, sample_rate). Cached — see
    ``_STACKED_CACHE``; callers must treat the batch as read-only.
    """
    import jax.numpy as jnp

    paths = list_speaker_wavs(data_path, speaker)
    if nb_file is not None:
        paths = paths[:nb_file]
    key = (tuple(paths), int(step))
    hit = _STACKED_CACHE.get(key)
    if hit is not None:
        return hit
    sigs, sr = load_speaker(data_path, speaker, nb_file=nb_file,
                            cpu_rate=cpu_rate)
    max_len = max(len(s) for s in sigs)
    target = ((max_len + step - 1) // step) * step
    batch = np.zeros((len(sigs), target), dtype=np.float32)
    for i, s in enumerate(sigs):
        batch[i, : len(s)] = s
    out = (jnp.asarray(batch),
           np.asarray([len(s) for s in sigs], np.int64), int(sr))
    if len(_STACKED_CACHE) >= _STACKED_CACHE_MAX:
        _STACKED_CACHE.pop(next(iter(_STACKED_CACHE)))
    _STACKED_CACHE[key] = out
    return out


def load_speaker(
    data_path: str,
    speaker: str,
    nb_file: int | None = None,
    cache_dir: str | None = None,
    use_native: bool = True,
    cpu_rate: float = 0.6,
) -> tuple[list[np.ndarray], int]:
    """Load all wavs of one speaker → (list of float64 signals, sample_rate).

    Replaces ``io_read_speaker_data`` + npy whole-speaker cache
    (``utils.py:116-171``). Uses the native C++ threaded loader when built,
    else the numpy reader. Caching is per-speaker ``.npz`` (object arrays are
    avoided; ragged signals stored concatenated + offsets) plus an in-process
    decoded-signal cache (callers treat the signals as read-only).
    """
    paths = list_speaker_wavs(data_path, speaker)
    if nb_file is not None:
        paths = paths[:nb_file]
    if not paths:
        raise FileNotFoundError(f"no wavs for speaker {speaker} under {data_path}")

    mem_key = tuple(paths)
    hit = _SPEAKER_CACHE.get(mem_key)
    if hit is not None:
        return hit

    cache = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        key = hashlib.sha1(("|".join(paths)).encode()).hexdigest()[:16]
        cache = os.path.join(cache_dir, f"{speaker}_{key}.npz")
        if os.path.isfile(cache):
            z = np.load(cache)
            flat, offs, sr = z["flat"], z["offsets"], int(z["sr"])
            sigs = [flat[offs[i] : offs[i + 1]] for i in range(len(offs) - 1)]
            if len(_SPEAKER_CACHE) >= _SPEAKER_CACHE_MAX:
                _SPEAKER_CACHE.pop(next(iter(_SPEAKER_CACHE)))
            _SPEAKER_CACHE[mem_key] = (sigs, sr)
            return sigs, sr

    sigs: list[np.ndarray] = []
    sr = None
    if use_native:
        try:
            from exemplars_vc_tpu.io import native

            if native.available():
                # decode-thread throttle, the reference's cpu_rate knob
                # (config/config:47, utils.py:183: workers = cpu_rate * cores)
                n_threads = max(1, int(cpu_rate * (os.cpu_count() or 1)))
                sigs, sr = native.read_wavs(paths, n_threads=n_threads)
        except Exception:
            sigs = []
    if not sigs:
        for p in paths:
            x, this_sr = read_wav(p)
            if sr is not None and this_sr != sr:
                raise ValueError(f"inconsistent sample rates in {speaker}: {this_sr} vs {sr}")
            sr = this_sr
            sigs.append(x)

    if cache is not None:
        offs = np.zeros(len(sigs) + 1, dtype=np.int64)
        offs[1:] = np.cumsum([len(s) for s in sigs])
        flat = np.concatenate(sigs) if sigs else np.zeros(0)
        np.savez(cache, flat=flat, offsets=offs, sr=sr)
    if len(_SPEAKER_CACHE) >= _SPEAKER_CACHE_MAX:
        _SPEAKER_CACHE.pop(next(iter(_SPEAKER_CACHE)))
    _SPEAKER_CACHE[mem_key] = (sigs, int(sr))
    return sigs, int(sr)


def bucketed_signal(sig: np.ndarray, hop_length: int, frame_bucket: int = 128):
    """Zero-pad a signal so its centered-STFT frame count lands on a bucket
    boundary: with n_frames = 1 + len//hop, pad len to a multiple of
    hop·frame_bucket. Caps the number of distinct jit shapes (≈ one compile
    per bucket instead of one per utterance). Returns (padded signal,
    true_frames)."""
    step = hop_length * frame_bucket
    n = len(sig)
    target = ((n + step - 1) // step) * step if n else step
    true_frames = 1 + n // hop_length
    return np.pad(sig, (0, target - n)), true_frames


def pad_to_bucket(x: np.ndarray, bucket: int, axis: int = 0) -> tuple[np.ndarray, int]:
    """Pad ``axis`` up to the next multiple of ``bucket``; return (padded, true_len)."""
    n = x.shape[axis]
    target = ((n + bucket - 1) // bucket) * bucket if n else bucket
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad), n


def stack_ragged(
    arrays: list[np.ndarray], bucket: int = 128
) -> tuple[np.ndarray, np.ndarray]:
    """Stack ragged (T_i, D) arrays into (N, T_max_padded, D) + lengths (N,).

    The fixed-shape replacement for the reference's python-list-of-utterances
    representation (``01_make_dict_parallel.py`` throughout)."""
    t_max = max(a.shape[0] for a in arrays)
    t_pad = ((t_max + bucket - 1) // bucket) * bucket
    out = np.zeros((len(arrays), t_pad) + arrays[0].shape[1:], dtype=arrays[0].dtype)
    lens = np.zeros(len(arrays), dtype=np.int32)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
        lens[i] = a.shape[0]
    return out, lens


@dataclass
class ArtifactStore:
    """Content-addressed stage-output store: every pipeline stage checks
    before recompute, so a crashed run resumes at the last completed stage —
    the typed version of the reference's pickle-checkpoint pattern
    (``04_align_n_nmf.py:251-302``).

    Writes are asynchronous by default: ``save`` hands the arrays to a
    background thread that materializes them (``np.asarray`` — for device
    arrays this is the device→host transfer, deliberately moved OFF the
    pipeline's critical path) and writes atomically (tmp + rename).
    ``has``/``load`` join any pending write of that name first, so within-process semantics are identical to
    synchronous writes; a crash mid-write can only lose the *newest* stage,
    which then recomputes — the same contract as the reference's
    write-at-stage-end pickles. Writer threads are non-daemon, so normal
    interpreter exit completes all writes. Set ``async_writes=False`` for
    strictly synchronous stores."""

    root: str
    async_writes: bool = True

    def __post_init__(self):
        import threading

        self._pending: dict[str, object] = {}
        self._errors: dict[str, BaseException] = {}
        self._lock = threading.Lock()

    def _path(self, name: str) -> str:
        os.makedirs(self.root, exist_ok=True)
        return os.path.join(self.root, f"{name}.npz")

    def _write(self, name: str, arrays: dict) -> None:
        try:
            arrays = {k: np.asarray(v) for k, v in arrays.items()}
            tmp = self._path(name) + ".tmp.npz"  # np.savez appends .npz otherwise
            np.savez(tmp, **arrays)
            os.replace(tmp, self._path(name))  # atomic: no torn artifacts on crash
        except BaseException as e:  # re-raised on the next join of this name
            with self._lock:
                self._errors[name] = e

    def _join(self, name: str) -> None:
        with self._lock:
            t = self._pending.pop(name, None)
        if t is not None:
            t.join()
        with self._lock:
            err = self._errors.pop(name, None)
        if err is not None:
            raise RuntimeError(f"async artifact write of {name!r} failed") from err

    def flush(self) -> None:
        """Block until every pending write has landed (re-raising failures)."""
        with self._lock:
            names = list(self._pending)
        for name in names:
            self._join(name)

    def has(self, name: str) -> bool:
        self._join(name)
        return os.path.isfile(self._path(name))

    def save(self, name: str, **arrays: np.ndarray) -> None:
        if not self.async_writes:
            self._write(name, arrays)
            err = self._errors.pop(name, None)
            if err is not None:
                raise RuntimeError(f"artifact write of {name!r} failed") from err
            return
        import threading

        self._join(name)  # serialize writes of the same artifact
        t = threading.Thread(
            target=self._write, args=(name, arrays), name=f"evc-save-{name}"
        )
        with self._lock:
            self._pending[name] = t
        t.start()

    def load(self, name: str) -> dict[str, np.ndarray]:
        self._join(name)
        with np.load(self._path(name)) as z:
            return {k: z[k] for k in z.files}

    def save_json(self, name: str, obj) -> None:
        p = os.path.join(self.root, f"{name}.json")
        os.makedirs(self.root, exist_ok=True)
        with open(p + ".tmp", "w") as f:
            json.dump(obj, f)
        os.replace(p + ".tmp", p)

    def load_json(self, name: str):
        with open(os.path.join(self.root, f"{name}.json")) as f:
            return json.load(f)

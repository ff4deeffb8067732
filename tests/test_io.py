import numpy as np

from exemplars_vc_tpu.io import read_wav, write_wav, load_speaker, stack_ragged, ArtifactStore
from exemplars_vc_tpu.io.store import pad_to_bucket


def test_wav_roundtrip(tmp_path):
    sr = 16000
    t = np.arange(sr) / sr
    x = 0.5 * np.sin(2 * np.pi * 220 * t)
    p = str(tmp_path / "a.wav")
    write_wav(p, x, sr)
    y, sr2 = read_wav(p)
    assert sr2 == sr
    assert y.shape == x.shape
    assert np.max(np.abs(y - x)) < 1.0 / 32000


def test_read_wav_mono_false_returns_channels(tmp_path):
    """mono=False returns (C, T) — stereo files keep real channels, mono
    files are promoted to (1, T). Stereo written by interleaving int16."""
    import struct

    sr = 8000
    t = np.arange(sr) / sr
    left = (0.5 * np.sin(2 * np.pi * 220 * t) * 32767).astype(np.int16)
    right = (0.25 * np.sin(2 * np.pi * 440 * t) * 32767).astype(np.int16)
    inter = np.empty(2 * sr, np.int16)
    inter[0::2] = left
    inter[1::2] = right
    raw = inter.tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE"
           + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 2, sr, sr * 4, 4, 16)
           + b"data" + struct.pack("<I", len(raw)))
    p = str(tmp_path / "st.wav")
    with open(p, "wb") as fh:
        fh.write(hdr + raw)

    x, got_sr = read_wav(p, mono=False)
    assert got_sr == sr and x.shape == (2, sr)
    assert np.max(np.abs(x[0] - left / 32768.0)) < 1e-4
    assert np.max(np.abs(x[1] - right / 32768.0)) < 1e-4
    # mono=True still downmixes
    m, _ = read_wav(p)
    assert m.shape == (sr,)
    assert np.allclose(m, (x[0] + x[1]) / 2.0, atol=1e-6)
    # mono file promoted to (1, T)
    pm = str(tmp_path / "m.wav")
    write_wav(pm, np.sin(2 * np.pi * 220 * t), sr)
    xm, _ = read_wav(pm, mono=False)
    assert xm.shape == (1, sr)


def test_read_reference_wav(sf1_wav):
    x, sr = sf1_wav
    assert sr == 16000
    assert x.dtype == np.float64
    assert x.ndim == 1 and len(x) > sr  # at least 1 s
    assert np.max(np.abs(x)) <= 1.0


def test_load_speaker_cache(tmp_path, corpus_data):
    from exemplars_vc_tpu.io import store as store_mod

    store_mod._SPEAKER_CACHE.clear()
    sigs, sr = load_speaker(corpus_data, "SF1", nb_file=3, cache_dir=str(tmp_path))
    assert len(sigs) == 3 and sr == 16000
    # force the npz disk-cache branch (not the in-process cache)
    store_mod._SPEAKER_CACHE.clear()
    sigs2, _ = load_speaker(corpus_data, "SF1", nb_file=3, cache_dir=str(tmp_path))
    for a, b in zip(sigs, sigs2):
        np.testing.assert_array_equal(a, b)
    # in-process cache: same objects back without re-decode
    sigs3, _ = load_speaker(corpus_data, "SF1", nb_file=3, cache_dir=str(tmp_path))
    assert sigs3[0] is sigs2[0]


def test_stack_ragged():
    arrays = [np.ones((10, 4)), np.ones((300, 4)), np.ones((129, 4))]
    out, lens = stack_ragged(arrays, bucket=128)
    assert out.shape == (3, 384, 4)
    assert lens.tolist() == [10, 300, 129]
    assert out[0, 10:].sum() == 0


def test_pad_to_bucket():
    x = np.ones((130, 3))
    p, n = pad_to_bucket(x, 128)
    assert p.shape == (256, 3) and n == 130


def test_artifact_store(tmp_path):
    store = ArtifactStore(str(tmp_path))
    assert not store.has("stage1")
    store.save("stage1", a=np.arange(5), b=np.eye(2))
    assert store.has("stage1")
    back = store.load("stage1")
    np.testing.assert_array_equal(back["a"], np.arange(5))
    store.save_json("meta", {"n": 3})
    assert store.load_json("meta")["n"] == 3


def test_artifact_store_async_semantics(tmp_path):
    """Async writes must be invisible within the process: has/load join the
    pending write; flush blocks until everything landed on disk."""
    import os

    store = ArtifactStore(str(tmp_path), async_writes=True)
    big = np.random.default_rng(0).random((512, 512))
    for i in range(4):
        store.save(f"stage{i}", x=big * i)
    # immediate read-back sees the just-written artifact
    np.testing.assert_array_equal(store.load("stage2")["x"], big * 2)
    store.flush()
    for i in range(4):
        assert os.path.isfile(tmp_path / f"stage{i}.npz")
    # overwrite of the same name serializes: last write wins
    store.save("stage0", x=big * 7)
    store.save("stage0", x=big * 9)
    np.testing.assert_array_equal(store.load("stage0")["x"], big * 9)


def test_artifact_store_async_accepts_device_arrays(tmp_path):
    """The writer thread materializes jax arrays (device→host off the
    caller's critical path) — float16 casts included."""
    import jax.numpy as jnp

    store = ArtifactStore(str(tmp_path))
    dev = jnp.arange(12.0).reshape(3, 4)
    store.save("dev", x=dev.astype(jnp.float16), lens=np.array([3]))
    back = store.load("dev")
    assert back["x"].dtype == np.float16
    np.testing.assert_allclose(back["x"].astype(np.float64),
                               np.arange(12.0).reshape(3, 4))


def test_artifact_store_async_error_propagates(tmp_path):
    store = ArtifactStore(str(tmp_path))

    class Boom:
        def __array__(self):
            raise ValueError("cannot materialize")

    store.save("bad", x=Boom())
    try:
        store.load("bad")
    except RuntimeError as e:
        assert "bad" in str(e)
    else:
        raise AssertionError("expected the async write failure to re-raise")


def test_bucketed_signal_boundaries():
    from exemplars_vc_tpu.io.store import bucketed_signal

    hop, bucket = 80, 128
    step = hop * bucket
    # exact multiple stays put
    x = np.ones(step)
    p, n = bucketed_signal(x, hop, bucket)
    assert len(p) == step and n == 1 + step // hop
    # one sample over rounds up a full bucket
    p2, n2 = bucketed_signal(np.ones(step + 1), hop, bucket)
    assert len(p2) == 2 * step and n2 == 1 + (step + 1) // hop
    # empty signal gets one bucket
    p3, _ = bucketed_signal(np.zeros(0), hop, bucket)
    assert len(p3) == step


def test_wav_extensible_float_format(tmp_path):
    """WAVE_FORMAT_EXTENSIBLE with a float SubFormat GUID must decode as
    float (regression for the 0xFFFE ambiguity)."""
    import struct

    sr = 16000
    x = (0.25 * np.sin(2 * np.pi * 220 * np.arange(1000) / sr)).astype(np.float32)
    body = x.tobytes()
    # extensible fmt chunk: base(16) + cbSize(2) validBits(2) chMask(4) GUID(16);
    # GUID starts with the real format code (3 = IEEE float)
    sub_guid = struct.pack("<H", 3) + b"\x00\x00" + b"\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
    fmt = struct.pack("<HHIIHH", 0xFFFE, 1, sr, sr * 4, 4, 32)
    fmt += struct.pack("<HHI", 22, 32, 0) + sub_guid
    p = tmp_path / "ext.wav"
    with open(p, "wb") as f:
        data_len = len(body)
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + data_len) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", data_len) + body)
    y, got_sr = read_wav(str(p))
    assert got_sr == sr
    np.testing.assert_allclose(y, x.astype(np.float64), atol=1e-6)


def test_wav_truncated_data_chunk(tmp_path):
    sr = 16000
    x = np.zeros(100)
    p = str(tmp_path / "t.wav")
    write_wav(p, x, sr)
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[:-3])   # cut mid-sample
    y, _ = read_wav(p)              # must not raise; trims to whole frames
    assert len(y) in (98, 99)

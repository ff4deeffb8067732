import glob
import os

import numpy as np
import pytest

from exemplars_vc_tpu.io import native, read_wav

def test_native_matches_python_reader(corpus_data):
    if not native.available():
        pytest.skip("native loader not built and no toolchain")
    paths = sorted(glob.glob(os.path.join(corpus_data, "SF1", "*.wav")))[:4]
    sigs, sr = native.read_wavs(paths)
    assert sr == 16000
    for p, s in zip(paths, sigs):
        ref, ref_sr = read_wav(p)
        assert ref_sr == sr
        assert s.dtype == np.float64
        np.testing.assert_array_equal(s, ref)


def test_native_error_paths(tmp_path):
    if not native.available():
        pytest.skip("native loader not built")
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"this is not a wav file at all")
    with pytest.raises(ValueError, match="not a RIFF"):
        native.read_wavs([str(bad)])
    with pytest.raises(ValueError, match="cannot read"):
        native.read_wavs([str(tmp_path / "missing.wav")])


def test_native_multithreaded_batch(tmp_path):
    if not native.available():
        pytest.skip("native loader not built")
    from exemplars_vc_tpu.io import write_wav

    rng = np.random.default_rng(0)
    paths = []
    refs = []
    for i in range(16):
        x = 0.5 * rng.standard_normal(1000 + 17 * i)
        p = str(tmp_path / f"f{i}.wav")
        write_wav(p, x, 16000)
        paths.append(p)
        refs.append(read_wav(p)[0])
    sigs, sr = native.read_wavs(paths, n_threads=8)
    assert sr == 16000
    for s, r in zip(sigs, refs):
        np.testing.assert_array_equal(s, r)

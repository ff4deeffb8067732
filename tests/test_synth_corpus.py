"""The seeded parallel corpus: deterministic, in the layout the pipeline
reads, with utterance lengths in range."""

import os

import numpy as np
import pytest

from exemplars_vc_tpu.io import read_wav
from exemplars_vc_tpu.io.store import list_speaker_wavs
from exemplars_vc_tpu.io.synth_corpus import HELD_OUT_UTT, bench_data, write_corpus
from exemplars_vc_tpu.pipelines.evaluate import heldout_pair


def _wavs(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith(".wav"):
                p = os.path.join(d, n)
                with open(p, "rb") as f:
                    out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("small"))
    return root, write_corpus(root, seed=3, n_pairs=2, min_s=1.0, max_s=1.5)


def test_deterministic_by_seed(small, tmp_path):
    root, _ = small
    again = write_corpus(str(tmp_path / "again"), seed=3, n_pairs=2,
                         min_s=1.0, max_s=1.5)
    other = write_corpus(str(tmp_path / "other"), seed=4, n_pairs=2,
                         min_s=1.0, max_s=1.5)
    a, b, c = _wavs(root), _wavs(os.path.dirname(again)), _wavs(os.path.dirname(other))
    assert set(a) == set(b) == set(c) and len(a) == 6
    assert a == b
    assert all(a[k] != c[k] for k in a)


def test_layout_is_what_the_pipeline_reads(small):
    _, data = small
    for spk in ("SF1", "TF1"):
        names = [os.path.basename(p) for p in list_speaker_wavs(data, spk)]
        assert names == ["100001.wav", "100002.wav"]
    src, tar = heldout_pair(data)
    assert os.path.isfile(src) and os.path.isfile(tar)
    assert f"{HELD_OUT_UTT}.wav" not in os.listdir(os.path.join(data, "SF1"))


@pytest.mark.parametrize("bounds", [(1.0, 1.5), (2.5, 4.5)])
def test_lengths_in_range_pcm16_finite(tmp_path, bounds):
    data = write_corpus(str(tmp_path), seed=0, n_pairs=3, min_s=bounds[0],
                        max_s=bounds[1])
    paths = (list_speaker_wavs(data, "SF1") + list_speaker_wavs(data, "TF1")
             + list(heldout_pair(data)))
    lengths = []
    for p in paths:
        x, sr = read_wav(p)
        assert sr == 16000 and np.isfinite(x).all()
        assert 0.1 < np.abs(x).max() <= 1.0
        lengths.append(len(x) / sr)
    assert bounds[0] <= min(lengths) and max(lengths) <= bounds[1]


def test_speakers_differ_by_a_time_warp(small):
    """Same text, own durations: the renditions of an utterance differ in
    length, so DTW has real work to do."""
    _, data = small
    src, tar = heldout_pair(data)
    assert len(read_wav(src)[0]) != len(read_wav(tar)[0])


def test_rewrite_with_same_parameters_is_skipped(small):
    root, data = small
    before = os.path.getmtime(os.path.join(data, "SF1", "100001.wav"))
    assert write_corpus(root, seed=3, n_pairs=2, min_s=1.0, max_s=1.5) == data
    assert os.path.getmtime(os.path.join(data, "SF1", "100001.wav")) == before


def test_bench_data_honours_env(monkeypatch, small):
    _, data = small
    monkeypatch.setenv("EVC_BENCH_DATA", data)
    assert bench_data() == data

"""Held-out evaluation (pipelines/evaluate.py) on the seeded corpus.

The held-out protocol is the reference's own: utterance 100162 is hard-coded
as its eval input (``04_align_n_nmf.py:439-440``) and is NOT in the
dictionary-build set; the pair lives at ``wav/SF1_100162.wav`` /
``wav/TF1_100162.wav`` beside the ``data/`` root.
"""

import os

import numpy as np
import pytest

from exemplars_vc_tpu.config import load_config
from exemplars_vc_tpu.pipelines.evaluate import (
    HELD_OUT_UTT,
    heldout_pair,
    no_conversion_baseline,
    reference_artifacts,
)

@pytest.fixture(scope="module")
def cfg():
    return load_config(overrides=["data.tar=TF1", "misc.nb_file=8"])


def test_heldout_pair_exists_and_is_held_out(cfg, corpus_data):
    src, tar = heldout_pair(corpus_data, cfg.data.src, cfg.data.tar)
    assert os.path.isfile(src) and os.path.isfile(tar)
    # 100162 must NOT be a dictionary-build utterance — that's the point
    bundled = set(os.listdir(os.path.join(corpus_data, "SF1")))
    assert f"{HELD_OUT_UTT}.wav" not in bundled


def test_reference_artifacts_readable(corpus_data):
    """The reference's committed end-to-end outputs are float64 wavs
    (scipy wavfile.write of float64 arrays) — io/wav must read them."""
    from exemplars_vc_tpu.io import read_wav

    refs = reference_artifacts(corpus_data)
    if not refs:
        pytest.skip("the reference's committed outputs are not in this corpus")
    assert set(refs) == {"ref_demo_world", "ref_org_world"}
    for p in refs.values():
        x, sr = read_wav(p)
        assert sr == 16000
        assert x.ndim == 1 and x.shape[0] > 16000
        assert np.isfinite(x).all()


def test_no_conversion_baseline_positive(cfg, corpus_data):
    v = no_conversion_baseline(cfg, corpus_data)
    assert np.isfinite(v) and v > 0


def test_convert_f0_logmv_statistics():
    """Voiced frames map to the target's log-f0 statistics; unvoiced stays 0."""
    import jax.numpy as jnp

    from exemplars_vc_tpu.pipelines.convert import convert_f0_logmv

    rng = np.random.default_rng(0)
    # source dictionary ~ logN(log 120, 0.1); target ~ logN(log 220, 0.2)
    A = np.exp(np.log(120.0) + 0.1 * rng.standard_normal((4000, 1)))
    B = np.exp(np.log(220.0) + 0.2 * rng.standard_normal((4000, 1)))
    A[::7] = 0.0  # unvoiced dictionary rows must not pollute the stats
    B[::5] = 0.0
    f0 = np.exp(np.log(120.0) + 0.1 * rng.standard_normal((300, 1)))
    f0[:50] = 0.0  # unvoiced input frames
    out = np.asarray(convert_f0_logmv(
        jnp.asarray(f0, jnp.float32), jnp.asarray(A, jnp.float32),
        jnp.asarray(B, jnp.float32)))
    assert (out[:50] == 0.0).all()
    voiced = out[50:]
    assert (voiced > 0).all()
    lv = np.log(voiced)
    lb = np.log(B[B > 0])
    # mapped voiced stats match the target dictionary's (both estimated on
    # finite samples → loose tolerances)
    assert abs(lv.mean() - lb.mean()) < 0.05
    assert abs(lv.std() / lb.std() - 1.0) < 0.15


def test_convert_f0_logmv_identity():
    """Same source and target statistics → the transform is ~identity on
    voiced frames."""
    import jax.numpy as jnp

    from exemplars_vc_tpu.pipelines.convert import convert_f0_logmv

    rng = np.random.default_rng(1)
    A = np.exp(np.log(150.0) + 0.15 * rng.standard_normal((5000, 1)))
    f0 = np.exp(np.log(150.0) + 0.15 * rng.standard_normal((200, 1)))
    out = np.asarray(convert_f0_logmv(
        jnp.asarray(f0, jnp.float32), jnp.asarray(A, jnp.float32),
        jnp.asarray(A, jnp.float32)))
    np.testing.assert_allclose(out[:, 0], f0[:, 0], rtol=1e-4)


def test_sync_stages_timing_keys(cfg, tmp_path, corpus_data):
    """sync_stages renames the solver/synthesis stages so the async and
    fenced views can't be confused."""
    from exemplars_vc_tpu.io import ArtifactStore
    from exemplars_vc_tpu.pipelines.convert import convert_utterance

    store = ArtifactStore(str(tmp_path / "store"))
    wav = os.path.join(corpus_data, "SF1", "100001.wav")
    res_async = convert_utterance(cfg, store, corpus_data, wav, nb_file=2,
                                  synth_iters=5)
    assert "nmf_dispatch" in res_async.timings
    assert "synthesis+nmf_drain" in res_async.timings
    res_sync = convert_utterance(cfg, store, corpus_data, wav, nb_file=2,
                                 synth_iters=5, sync_stages=True)
    assert "nmf_solve" in res_sync.timings
    assert "synthesis" in res_sync.timings


def test_evaluate_loo_two_folds(cfg, tmp_path, corpus_data):
    """Bounded LOO smoke/gate: two folds, stft_quality only. Each fold's
    dictionary excludes the held-out pair (7 pairs), and the fold-mean must
    beat the no-conversion anchor mean by ≥ 0.8 dB."""
    from exemplars_vc_tpu.io import ArtifactStore
    from exemplars_vc_tpu.pipelines.evaluate import evaluate_loo

    store = ArtifactStore(str(tmp_path / "loo_store"))
    results, summary = evaluate_loo(
        cfg, store, corpus_data, configs=["stft_quality"], synth_iters=20,
        folds=["100001", "100005"],
        audio_dir=str(tmp_path / "loo_audio"))
    assert [f.utt for f in results] == ["100001", "100005"]
    s = summary["stft_quality"]
    assert s["n"] == 2
    assert s["mean"] < s["anchor_mean"] - 0.8, summary
    assert s["folds_beating_anchor"] == 2
    # listening artifacts written per fold
    assert os.path.isfile(str(tmp_path / "loo_audio" / "stft_quality_100001.wav"))
    # the fold dictionary really excludes the held-out pair: 7 symlinks
    fold_dir = os.path.join(store.root, "loo", "data_wo_100001", "SF1")
    wavs = [n for n in os.listdir(fold_dir) if n.endswith(".wav")]
    assert len(wavs) == 7 and "100001.wav" not in wavs

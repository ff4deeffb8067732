import json
import os

import numpy as np
import pytest

from exemplars_vc_tpu.config import load_config
from exemplars_vc_tpu.io import ArtifactStore
from exemplars_vc_tpu.obs import mcd, mcd_aligned, spectral_convergence
from exemplars_vc_tpu.pipelines import (
    build_conversion_dicts,
    convert_utterance,
    make_dictionary,
)

DATA = "/root/reference/data"
pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(DATA, "SF1")), reason="reference data missing"
)


@pytest.fixture(scope="module")
def cfg():
    # TF1 is what's bundled (TM3 only exists in the full corpus)
    return load_config(overrides=["data.tar=TF1", "misc.nb_file=4"])


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return ArtifactStore(str(tmp_path_factory.mktemp("artifacts")))


def test_make_dictionary(cfg, store):
    art = make_dictionary(cfg, store, DATA, nb_file=4)
    assert art.path_len.shape == (4,)
    assert (art.path_len > 0).all()
    # paths end at the true last frames
    for n in range(4):
        ln = int(art.path_len[n])
        assert art.path_i[n, ln - 1] == art.len_a[n] - 1
        assert art.path_j[n, ln - 1] == art.len_b[n] - 1
    # cache hit path returns identical artifacts
    art2 = make_dictionary(cfg, store, DATA, nb_file=4)
    np.testing.assert_array_equal(art.path_i, art2.path_i)


def test_conversion_dicts(cfg, store):
    f = build_conversion_dicts(cfg, store, DATA, "SF1", nb_file=4)
    assert f.kind == "stft"
    assert f.feats["stft"].shape[0] == 4
    assert f.feats["stft"].shape[2] == 201
    assert (f.lens > 0).all()


def test_convert_utterance_stft(cfg, store, tmp_path):
    out = str(tmp_path / "conv.wav")
    res = convert_utterance(
        cfg, store, DATA, os.path.join(DATA, "SF1", "100001.wav"),
        out_path=out, nb_file=4, synth_iters=30,
        reference_wav=os.path.join(DATA, "TF1", "100001.wav"),
    )
    assert os.path.isfile(out)
    assert res.audio.ndim == 1 and res.audio.shape[0] > 16000
    assert np.isfinite(res.audio).all()
    assert res.nmf_error > 0
    # converted magnitude is non-negative and finite
    Y = res.converted["stft"]
    assert (Y >= -1e-5).all() and np.isfinite(Y).all()
    # conversion quality guard: DTW-aligned MCD vs the true target utterance.
    # Gated BOTH absolutely (≤4.5 dB) and against the committed snapshot
    # (golden + 0.3 dB) so perf work can't silently
    # degrade output.
    assert res.mcd_vs_reference is not None
    gold = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                "convert_snapshot.npz"))
    assert res.mcd_vs_reference < 4.5, res.mcd_vs_reference
    assert res.mcd_vs_reference <= float(gold["stft_mcd"]) + 0.3
    # spectral-snapshot regression on the converted magnitude
    snap = Y[::16, ::4].astype(np.float32)
    ref_snap = gold["stft_mag"]
    assert snap.shape == ref_snap.shape
    dev_db = np.abs(10 * np.log10((snap + 1e-6) / (ref_snap + 1e-6)))
    assert float(dev_db.mean()) < 0.3, float(dev_db.mean())


def test_convert_kl_context_improves_mcd(cfg, store, tmp_path):
    """Beyond-reference quality settings: KL beta-loss + multi-frame
    exemplars (nmf.context_frames) must measurably beat the reference's
    frobenius/single-frame settings on the same data (measured ≈ −1.0 to
    −2.5 dB across the bundled utterances)."""
    from dataclasses import replace

    src = os.path.join(DATA, "SF1", "100001.wav")
    ref = os.path.join(DATA, "TF1", "100001.wav")
    base = convert_utterance(cfg, store, DATA, src, nb_file=4,
                             synth_iters=30, reference_wav=ref)
    cfg_q = replace(cfg, nmf=replace(
        cfg.nmf, beta_loss="kullback-leibler", context_frames=3))
    qual = convert_utterance(cfg_q, store, DATA, src, nb_file=4,
                             synth_iters=30, reference_wav=ref)
    assert qual.mcd_vs_reference < base.mcd_vs_reference - 0.8, (
        base.mcd_vs_reference, qual.mcd_vs_reference)
    assert qual.mcd_vs_reference < 3.6, qual.mcd_vs_reference


def test_metrics():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((50, 26)), jnp.float32)
    assert float(mcd(a, a)) == 0.0
    b = a + 0.1
    assert float(mcd(a, b)) > 0
    # alignment-based MCD handles different lengths
    v = float(mcd_aligned(a, a[::2]))
    assert np.isfinite(v)
    assert float(spectral_convergence(a, a)) == 0.0


def test_cli_make_dict(cfg, tmp_path, capsys):
    from exemplars_vc_tpu.pipelines.cli import main

    main([
        "make-dict", "--data", DATA, "--store", str(tmp_path / "store"),
        "--tar", "TF1", "--nb-file", "2",
    ])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    payload = json.loads(out)
    assert payload["pairs"] == 2
    assert payload["total_exemplars"] > 0


def test_convert_utterance_world_path(store, tmp_path):
    cfg_world = load_config(overrides=[
        "data.tar=TF1", "misc.nb_file=2", "data.use_stft=false",
        "nmf.max_iter=30",
    ])
    out = str(tmp_path / "conv_world.wav")
    res = convert_utterance(
        cfg_world, store, DATA, os.path.join(DATA, "SF1", "100001.wav"),
        out_path=out, nb_file=2,
        reference_wav=os.path.join(DATA, "TF1", "100001.wav"),
    )
    assert os.path.isfile(out)
    assert np.isfinite(res.audio).all()
    assert set(res.converted) == {"sp", "ap", "f0"}
    # converted aperiodicity stays within physical range after (H B) * R
    ap = res.converted["ap"]
    assert np.isfinite(ap).all()
    # WORLD-path quality gate (was finiteness-only): MCD vs the true target
    # within 0.3 dB of the committed snapshot, plus an envelope snapshot
    gold = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                "convert_snapshot.npz"))
    assert res.mcd_vs_reference is not None
    assert res.mcd_vs_reference <= float(gold["world_mcd"]) + 0.3, (
        res.mcd_vs_reference
    )
    snap = res.converted["sp"][::16, ::8].astype(np.float32)
    ref_snap = gold["world_sp"]
    assert snap.shape == ref_snap.shape
    dev_db = np.abs(10 * np.log10((snap + 1e-12) / (ref_snap + 1e-12)))
    assert float(dev_db.mean()) < 0.3, float(dev_db.mean())


def test_cli_conv_dicts_and_demo(tmp_path, capsys):
    from exemplars_vc_tpu.pipelines.cli import main

    store = str(tmp_path / "store")
    main(["conv-dicts", "--data", DATA, "--store", store, "--tar", "TF1",
          "--nb-file", "2"])
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert {l["speaker"] for l in lines} == {"SF1", "TF1"}
    assert all(l["kind"] == "stft" for l in lines)

    out = str(tmp_path / "demo.wav")
    main(["demo", "--data", DATA, "--store", store, "--tar", "TF1",
          "--nb-file", "2", "--out", out])
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert os.path.isfile(out)
    assert payload["samples"] > 16000


def test_cli_convert_dir(tmp_path, capsys):
    from exemplars_vc_tpu.pipelines.cli import main

    in_dir = tmp_path / "in"
    in_dir.mkdir()
    import shutil

    shutil.copy(os.path.join(DATA, "SF1", "100001.wav"), in_dir)
    main(["convert-dir", "--data", DATA, "--store", str(tmp_path / "store"),
          "--tar", "TF1", "--nb-file", "2", "--in-dir", str(in_dir),
          "--out-dir", str(tmp_path / "out"), "--synth-iters", "10"])
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["n_files"] == 1
    assert os.path.isfile(str(tmp_path / "out" / "100001.wav"))


def test_cli_separate(tmp_path, capsys):
    from exemplars_vc_tpu.pipelines.cli import main

    main(["separate", "--wav", os.path.join(DATA, "SF1", "100001.wav"),
          "--out-dir", str(tmp_path / "sep"), "--sources", "2",
          "--components", "2", "--em-iters", "4", "--n-fft", "128",
          "--hop", "64"])
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(payload["out"]) == 2
    assert all(os.path.isfile(p) for p in payload["out"])
    assert payload["nll_last"] < payload["nll_first"]


def test_cli_separate_lead(tmp_path, capsys):
    from exemplars_vc_tpu.pipelines.cli import main

    main(["separate-lead", "--wav", os.path.join(DATA, "SF1", "100001.wav"),
          "--out-dir", str(tmp_path / "lead"), "--model", "stereo",
          "--components", "4", "--iters", "4", "--n-fft", "512",
          "--hop", "128", "--f0-min", "120", "--f0-max", "350"])
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert os.path.isfile(payload["lead"])
    assert os.path.isfile(payload["accomp"])
    assert payload["voiced_frames"] > 0
    assert 120 <= payload["f0_median"] <= 350


def test_make_dictionary_mcep_feature(cfg, tmp_path):
    from exemplars_vc_tpu.io import ArtifactStore

    st = ArtifactStore(str(tmp_path / "mcep_store"))
    art = make_dictionary(cfg, st, DATA, feat="mcep", nb_file=2)
    assert art.feat_a.shape[-1] == 26      # order+1 mel-cepstral coefficients
    assert (art.path_len > 0).all()
    assert np.isfinite(art.feat_a).all()


def test_serve_converter_reuses_dictionaries(cfg, store, tmp_path):
    from exemplars_vc_tpu.pipelines.serve import Converter

    conv = Converter(cfg, store, DATA, nb_file=4)
    r1 = conv.convert(os.path.join(DATA, "SF1", "100001.wav"),
                      out_path=str(tmp_path / "s1.wav"), synth_iters=10)
    r2 = conv.convert(os.path.join(DATA, "SF1", "100002.wav"),
                      out_path=str(tmp_path / "s2.wav"), synth_iters=10)
    assert np.isfinite(r1.audio).all() and np.isfinite(r2.audio).all()
    assert r1.audio.shape != r2.audio.shape  # different utterances
    assert os.path.isfile(str(tmp_path / "s1.wav"))
    assert r1.nmf_iters > 0 and r2.nmf_iters > 0


@pytest.mark.parametrize("solver", ["cd", "qr", "mu_sharded"])
def test_convert_solver_variants(store, tmp_path, solver):
    cfg_s = load_config(overrides=[
        "data.tar=TF1", "misc.nb_file=2", f"nmf.solver={solver}",
        "nmf.max_iter=30",
    ])
    res = convert_utterance(
        cfg_s, store, DATA, os.path.join(DATA, "SF1", "100001.wav"),
        out_path=str(tmp_path / f"conv_{solver}.wav"), nb_file=2, synth_iters=10,
    )
    assert np.isfinite(res.audio).all()
    assert np.isfinite(res.converted["stft"]).all()


def test_convert_solver_mu_sharded_matches_mu(store, tmp_path):
    """nmf.solver=mu_sharded (dictionary K axis sharded over every device,
    one psum per MU iteration) is the production multi-chip composition; on
    the 8-virtual-device mesh its conversion must match the single-device
    Frobenius mu solver bit-for-bit up to float reduction order."""
    base = load_config(overrides=[
        "data.tar=TF1", "misc.nb_file=2", "nmf.max_iter=40", "nmf.tol=0",
    ])
    from dataclasses import replace

    res_mu = convert_utterance(
        base, store, DATA, os.path.join(DATA, "SF1", "100001.wav"),
        nb_file=2, synth_iters=5)
    cfg_sh = replace(base, nmf=replace(base.nmf, solver="mu_sharded"))
    res_sh = convert_utterance(
        cfg_sh, store, DATA, os.path.join(DATA, "SF1", "100001.wav"),
        nb_file=2, synth_iters=5)
    Y1 = np.asarray(res_mu.converted["stft"])
    Y2 = np.asarray(res_sh.converted["stft"])
    np.testing.assert_allclose(Y2, Y1, rtol=2e-3, atol=2e-3)
    assert np.isfinite(res_sh.audio).all()


def test_serve_convert_batch_matches_single(cfg, store, tmp_path):
    from exemplars_vc_tpu.pipelines.serve import Converter

    conv = Converter(cfg, store, DATA, nb_file=4)
    paths = [os.path.join(DATA, "SF1", n) for n in ("100001.wav", "100002.wav")]
    out_dir = str(tmp_path / "batch")
    os.makedirs(out_dir, exist_ok=True)
    batch = conv.convert_batch(paths, out_dir=out_dir, synth_iters=10)
    assert len(batch) == 2
    for p in paths:
        assert os.path.isfile(os.path.join(out_dir, os.path.basename(p)))
    # frame independence: batched activation solve == per-utterance solves
    single = conv.convert(paths[0], synth_iters=10)
    np.testing.assert_allclose(batch[0].audio, single.audio, atol=2e-4)


def test_dict_hop_divisor_densifies(cfg, tmp_path):
    """data.dict_hop_divisor=2 builds the dictionaries at hop/2 → ~2× the
    exemplars from the same audio; the conversion input keeps its grid."""
    from dataclasses import replace

    from exemplars_vc_tpu.pipelines.convert import _aligned_dicts

    st = ArtifactStore(str(tmp_path / "dense_store"))
    d1, _ = _aligned_dicts(cfg, st, DATA, 2)
    c2 = replace(cfg, data=replace(cfg.data, dict_hop_divisor=2))
    d2, _ = _aligned_dicts(c2, st, DATA, 2)
    k1 = np.asarray(d1["stft"][0]).shape[0]
    k2 = np.asarray(d2["stft"][0]).shape[0]
    assert 1.7 * k1 < k2 < 2.3 * k1, (k1, k2)
    # conversion still runs end-to-end and output length tracks the INPUT grid
    res = convert_utterance(c2, st, DATA, os.path.join(DATA, "SF1", "100001.wav"),
                            nb_file=2, synth_iters=5)
    assert np.isfinite(res.audio).all()


def test_serve_batch_exact_with_context_frames(cfg, store, tmp_path):
    """context_frames stacks per utterance inside convert_batch, so batch
    must stay exactly ≡ single-utterance conversion (no cross-utterance
    context bleed at the concatenation boundary)."""
    from dataclasses import replace

    from exemplars_vc_tpu.pipelines.serve import Converter

    cfg_c = replace(cfg, nmf=replace(cfg.nmf, context_frames=2))
    conv = Converter(cfg_c, store, DATA, nb_file=4)
    paths = [os.path.join(DATA, "SF1", n) for n in ("100001.wav", "100002.wav")]
    batch = conv.convert_batch(paths, synth_iters=10)
    single = conv.convert(paths[1], synth_iters=10)
    np.testing.assert_allclose(batch[1].audio, single.audio, atol=2e-4)


def test_serve_batch_exact_with_h_smooth(cfg, store):
    """nmf.h_smooth must not smear activations across utterance boundaries
    in the stacked batch solve: convert_batch solves with smoothing off and
    box-filters each utterance's H slice, so batch ≡ single exactly."""
    from dataclasses import replace

    from exemplars_vc_tpu.pipelines.serve import Converter

    cfg_s = replace(cfg, nmf=replace(cfg.nmf, h_smooth=2))
    conv = Converter(cfg_s, store, DATA, nb_file=4)
    paths = [os.path.join(DATA, "SF1", n) for n in ("100001.wav", "100002.wav")]
    batch = conv.convert_batch(paths, synth_iters=10)
    for i in range(2):
        single = conv.convert(paths[i], synth_iters=10)
        np.testing.assert_allclose(batch[i].audio, single.audio, atol=2e-4)


def test_serve_batch_mel_domain_with_context(cfg, store):
    """solve_domain='mel' + context_frames>0 used to raise in convert_batch;
    now the mel projection and context stacking run per utterance, so the
    combination works and stays ≡ single-utterance conversion."""
    from dataclasses import replace

    from exemplars_vc_tpu.pipelines.serve import Converter

    cfg_m = replace(cfg, nmf=replace(
        cfg.nmf, solve_domain="mel", solve_mels=40, context_frames=1,
        max_iter=30))
    conv = Converter(cfg_m, store, DATA, nb_file=4)
    paths = [os.path.join(DATA, "SF1", n) for n in ("100001.wav", "100002.wav")]
    batch = conv.convert_batch(paths, synth_iters=10)
    single = conv.convert(paths[1], synth_iters=10)
    np.testing.assert_allclose(batch[1].audio, single.audio, atol=2e-4)


def test_normalize_exemplars_unnormalized_basis(cfg):
    """nmf.normalize_exemplars solves on unit-L2 atoms but must return H in
    the UNNORMALIZED basis (H'·(A/s) == (H'/s)·A), so reconstruction H·A
    approximates X as well as the plain solve and zero padding rows keep
    zero activations (held-out quality impact measured +0.07 dB — opt-in,
    measured on the real held-out pair)."""
    from dataclasses import replace

    from exemplars_vc_tpu.pipelines.convert import _solve_activations

    rng = np.random.default_rng(7)
    X = np.abs(rng.standard_normal((24, 33))).astype(np.float32)
    A = np.abs(rng.standard_normal((40, 33))).astype(np.float32)
    A[13] *= 50.0          # wildly unequal atom energies
    A[-4:] = 0.0           # padding rows
    cfg_n = replace(cfg, nmf=replace(cfg.nmf, normalize_exemplars=True,
                                     max_iter=80, tol=0.0))
    cfg_b = replace(cfg, nmf=replace(cfg.nmf, max_iter=80, tol=0.0))
    Hn = np.asarray(_solve_activations(X, A, cfg_n).H)
    Hb = np.asarray(_solve_activations(X, A, cfg_b).H)
    assert np.isfinite(Hn).all() and (Hn >= 0).all()
    assert np.abs(Hn[:, -4:]).max() == 0.0
    rn = np.linalg.norm(X - Hn @ A) / np.linalg.norm(X)
    rb = np.linalg.norm(X - Hb @ A) / np.linalg.norm(X)
    assert rn < 1.2 * rb + 0.02, (rn, rb)


def test_dicts_memo_keyed_on_misc(cfg, tmp_path):
    """Two configs differing only in cfg.misc (file count via misc.nb_file)
    must not collide in the prepared-dictionary memo."""
    from dataclasses import replace

    from exemplars_vc_tpu.pipelines.convert import _aligned_dicts

    st = ArtifactStore(str(tmp_path / "memo_store"))
    c2 = replace(cfg, misc=replace(cfg.misc, nb_file=2))
    c3 = replace(cfg, misc=replace(cfg.misc, nb_file=3))
    d2, _ = _aligned_dicts(c2, st, DATA, None)
    d3, _ = _aligned_dicts(c3, st, DATA, None)
    k2 = np.asarray(d2["stft"][0]).shape[0]
    k3 = np.asarray(d3["stft"][0]).shape[0]
    assert k3 > k2, (k2, k3)


def test_conv_feats_key_includes_f0_method(tmp_path):
    """A harvest config must never silently reuse dio-extracted WORLD
    features from the store (f0 feeds CheapTrick/D4C, so every feature
    changes with the estimator)."""
    from dataclasses import replace

    from exemplars_vc_tpu.pipelines.conv_dicts import build_conversion_dicts

    st = ArtifactStore(str(tmp_path / "f0key_store"))
    base = load_config(overrides=[
        "data.tar=TF1", "misc.nb_file=2", "data.use_stft=false"])
    f_dio = build_conversion_dicts(base, st, DATA, "SF1", nb_file=2)
    harv = replace(base, world=replace(base.world, f0_method="harvest"))
    f_h = build_conversion_dicts(harv, st, DATA, "SF1", nb_file=2)
    d_dio = np.asarray(f_dio.feats["f0"])
    d_h = np.asarray(f_h.feats["f0"])
    assert not np.allclose(d_dio, d_h), "harvest hit the dio cache"


def test_vtlp_dictionary_augmentation():
    """data.dict_augment_warps: α=1 is identity; a warped copy moves a
    spectral peak to ~α·bin; f0 rows are tiled unwarped; every feature's
    exemplar count multiplies identically."""
    import jax.numpy as jnp

    from exemplars_vc_tpu.pipelines.convert import _augment_dicts, _vtlp_warp

    rng = np.random.default_rng(0)
    A = np.zeros((4, 201), np.float32)
    A[:, 100] = 1.0                      # spectral peak at bin 100
    one = np.asarray(_vtlp_warp(jnp.asarray(A), 1.0))
    np.testing.assert_allclose(one, A, atol=1e-6)
    up = np.asarray(_vtlp_warp(jnp.asarray(A), 1.1))
    assert abs(int(up[0].argmax()) - 110) <= 1    # content of f appears at α·f
    down = np.asarray(_vtlp_warp(jnp.asarray(A), 0.9))
    assert abs(int(down[0].argmax()) - 90) <= 1

    B = np.abs(rng.standard_normal((4, 201))).astype(np.float32)
    f0 = np.abs(rng.standard_normal((4, 1))).astype(np.float32)
    dicts = {"sp": (A, B), "f0": (f0, f0)}
    aug = _augment_dicts(dicts, (0.9, 1.1))
    assert aug["sp"][0].shape == (12, 201) and aug["sp"][1].shape == (12, 201)
    assert aug["f0"][0].shape == (12, 1)
    # the fused single-dispatch expansion ≡ [M; warp_α(M)…] per-α gathers
    Aa = np.asarray(aug["sp"][0])
    np.testing.assert_allclose(Aa[:4], A, atol=1e-6)
    np.testing.assert_allclose(Aa[4:8], np.asarray(_vtlp_warp(jnp.asarray(A), 0.9)),
                               atol=1e-4)
    np.testing.assert_allclose(Aa[8:], np.asarray(_vtlp_warp(jnp.asarray(A), 1.1)),
                               atol=1e-4)
    Bb = np.asarray(aug["sp"][1])
    np.testing.assert_allclose(Bb[4:8], np.asarray(_vtlp_warp(jnp.asarray(B), 0.9)),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(aug["sp"][0][:4]), A, atol=1e-6)
    np.testing.assert_allclose(np.asarray(aug["f0"][0]), np.tile(f0, (3, 1)))


def test_dicts_memo_transparent(cfg, tmp_path):
    """The in-process dictionary memo returns identical conversions and is
    keyed by store/config (a different store root misses)."""
    from exemplars_vc_tpu.io.store import list_speaker_wavs
    from exemplars_vc_tpu.pipelines import convert as C

    store = ArtifactStore(str(tmp_path))
    wav = list_speaker_wavs(DATA, "SF1")[0]
    C._DICTS_MEMO.clear()
    r1 = convert_utterance(cfg, store, DATA, wav, nb_file=3, synth_iters=10)
    assert len(C._DICTS_MEMO) == 1
    r2 = convert_utterance(cfg, store, DATA, wav, nb_file=3, synth_iters=10)
    np.testing.assert_allclose(r1.audio, r2.audio, atol=1e-6)
    assert len(C._DICTS_MEMO) == 1

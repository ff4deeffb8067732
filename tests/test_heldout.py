"""Held-out quality gates — the numbers of record.

Every assertion here converts the reference's own held-out eval utterance
(100162, ``04_align_n_nmf.py:439-440``) with the full 8-pair bundled
dictionaries, so a regression in GENERALIZATION fails CI even if the
in-dictionary snapshots (test_pipelines.py) still pass. Gated both against
the committed golden (+0.3 dB) and against the no-conversion baseline —
a conversion that scores worse than doing nothing is a broken conversion.
"""

import os
from dataclasses import replace

import numpy as np
import pytest

from exemplars_vc_tpu.config import load_config
from exemplars_vc_tpu.io import ArtifactStore
from exemplars_vc_tpu.pipelines.convert import convert_utterance
from exemplars_vc_tpu.pipelines.evaluate import _configs, heldout_pair

DATA = "/root/reference/data"
pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(DATA, "SF1")), reason="reference data missing"
)

GOLD = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                            "heldout_snapshot.npz"))


@pytest.fixture(scope="module")
def cfg():
    return load_config(overrides=["data.tar=TF1", "misc.nb_file=8"])


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return ArtifactStore(str(tmp_path_factory.mktemp("heldout_store")))


def _convert(cfg, store, name):
    src, tar = heldout_pair(DATA)
    c = _configs(cfg)[name]
    return convert_utterance(c, store, DATA, src, nb_file=8,
                             synth_iters=int(GOLD["synth_iters"]),
                             reference_wav=tar)


def test_heldout_stft_parity(cfg, store):
    res = _convert(cfg, store, "stft_parity")
    mcd = float(res.mcd_vs_reference)
    assert mcd <= float(GOLD["stft_parity_mcd"]) + 0.3, mcd
    # must beat the do-nothing anchor
    assert mcd < float(GOLD["no_conversion_mcd"]), mcd


def test_heldout_stft_quality(cfg, store):
    res = _convert(cfg, store, "stft_quality")
    mcd = float(res.mcd_vs_reference)
    assert mcd <= float(GOLD["stft_quality_mcd"]) + 0.3, mcd
    # the KL quality config must beat the no-conversion anchor by ≥ 1 dB
    assert mcd < float(GOLD["no_conversion_mcd"]) - 1.0, mcd


def test_heldout_world_quality(cfg, store):
    res = _convert(cfg, store, "world_quality")
    mcd = float(res.mcd_vs_reference)
    assert mcd <= float(GOLD["world_quality_mcd"]) + 0.3, mcd
    # below the no-conversion anchor, and within 1.5 dB of the STFT path
    # — the WORLD vocoder's own resynthesis
    # floor on this utterance is 5.41 dB MCD
    assert mcd < float(GOLD["no_conversion_mcd"]), mcd
    assert mcd <= float(GOLD["stft_quality_mcd"]) + 1.5, mcd


def test_heldout_context_frames_not_in_quality_config(cfg):
    """Guard the measured finding: ±context frames HELP in-dictionary but
    HURT held-out (memorization); the quality configs must keep ctx=0."""
    cs = _configs(cfg)
    assert cs["stft_quality"].nmf.context_frames == 0
    assert cs["world_quality"].nmf.context_frames == 0
    assert cs["world_quality"].world.sp_domain == "magnitude"
    assert cs["world_quality"].nmf.use_residual == "off"


def test_sp_domain_magnitude_physical(cfg, store, tmp_path):
    """Magnitude-domain sp solve returns a physical (non-negative, finite)
    envelope and plumbs through synthesis."""
    src, _ = heldout_pair(DATA)
    c = replace(_configs(cfg)["world_quality"], nmf=replace(
        _configs(cfg)["world_quality"].nmf, max_iter=30))
    res = convert_utterance(c, store, DATA, src, nb_file=2,
                            out_path=str(tmp_path / "wq.wav"))
    sp = np.asarray(res.converted["sp"])
    assert (sp >= 0).all() and np.isfinite(sp).all()
    assert np.isfinite(res.audio).all()

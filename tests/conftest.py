"""Test configuration: the CPU backend with 8 virtual devices, so multi-device
sharding logic runs (and is validated) without accelerators — the strategy
SURVEY.md §4 prescribes for the from-scratch test suite — and a seeded
synthetic parallel corpus (``io.synth_corpus``) as the pipeline's input."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def corpus_root(tmp_path_factory):
    """Seeded corpus root: ``data/{SF1,TF1}/*.wav`` (8 pairs of 1.5-2.5 s)
    plus the held-out pair under ``wav/``."""
    from exemplars_vc_tpu.io.synth_corpus import write_corpus

    root = str(tmp_path_factory.mktemp("corpus"))
    write_corpus(root, seed=0, n_pairs=8, min_s=1.5, max_s=2.5)
    return root


@pytest.fixture(scope="session")
def corpus_data(corpus_root):
    """The ``data/`` root of the seeded corpus, as the pipeline takes it."""
    return os.path.join(corpus_root, "data")


@pytest.fixture(scope="session")
def sf1_wav(corpus_data):
    """First SF1 utterance of the seeded corpus: (signal, sample_rate)."""
    from exemplars_vc_tpu.io import read_wav

    return read_wav(os.path.join(corpus_data, "SF1", "100001.wav"))

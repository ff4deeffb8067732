"""The CLI's main path on the CPU: make-dict, then convert, on a tiny seeded
corpus (2 pairs of 1 s, 10 MU iterations, 5 Griffin-Lim iterations)."""

import json
import os

import numpy as np

from exemplars_vc_tpu.io import read_wav
from exemplars_vc_tpu.io.synth_corpus import write_corpus
from exemplars_vc_tpu.pipelines.cli import main
from exemplars_vc_tpu.pipelines.evaluate import heldout_pair


def test_make_dict_then_convert(tmp_path, capsys):
    data = write_corpus(str(tmp_path / "corpus"), seed=1, n_pairs=2,
                        min_s=1.0, max_s=1.0)
    src, tar = heldout_pair(data)
    common = ["--data", data, "--store", str(tmp_path / "store"),
              "--nb-file", "2", "-o", "nmf.max_iter=10"]
    main(["make-dict", *common])
    made = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert made["pairs"] == 2 and made["total_exemplars"] > 0

    out = str(tmp_path / "out.wav")
    main(["convert", *common, "--wav", src, "--out", out,
          "--synth-iters", "5", "--ref-wav", tar])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert os.path.isfile(out)
    y, sr = read_wav(out)
    x, _ = read_wav(src)
    assert sr == 16000 and np.isfinite(y).all()
    assert abs(len(y) - len(x)) <= 80          # within one hop
    assert res["samples"] == len(y) and res["nmf_iters"] == 10
    assert np.isfinite(res["mcd_vs_reference"])


def test_main_path_imports_no_optional_packages(tmp_path):
    """make-dict and convert import nothing beyond jax, numpy, scipy and
    optax: orbax, tensorboardX, scikit-learn and torch stay optional."""
    import subprocess
    import sys

    data = write_corpus(str(tmp_path / "corpus"), seed=2, n_pairs=2,
                        min_s=1.0, max_s=1.0)
    src, _ = heldout_pair(data)
    common = ["--data", data, "--store", str(tmp_path / "store"),
              "--nb-file", "2", "-o", "nmf.max_iter=5"]
    code = (
        "import sys, json\n"
        "from exemplars_vc_tpu.pipelines.cli import main\n"
        f"main(['make-dict', *{common!r}])\n"
        f"main(['convert', *{common!r}, '--wav', {src!r}, '--synth-iters', '2'])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, timeout=300,
                       capture_output=True, text=True,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    loaded = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not loaded & {"orbax", "tensorboardX", "tensorboard", "sklearn", "torch"}

"""chip_smoke.py: refuses to run without a GPU, and ``--chips 4`` selects only
its own phase. The run on the card itself is the ``gpu``-marked test."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(args, cwd, env_update):
    env = dict(os.environ, **env_update)
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_refuses_cpu_only_jax():
    r = _run([], REPO, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_fails_alone_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run([], str(tmp_path), {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("argv, phases", [
    ([], ["convert", "reference", "large_dict", "world"]),
    (["--chips", "4"], ["four_cards"]),
    (["--chips", "4", "--phases", "convert"], ["four_cards"]),
    (["--phases", "convert"], ["convert"]),
])
def test_phase_selection(argv, phases):
    assert chip_smoke.select_phases(chip_smoke.parse_args(argv)) == phases


@pytest.fixture
def gpu():
    from exemplars_vc_tpu.runtime import gpu_name_and_power_limit

    if gpu_name_and_power_limit() is None:
        pytest.skip("needs an NVIDIA GPU (nvidia-smi)")


@pytest.mark.gpu
def test_convert_phase_on_gpu(gpu, tmp_path):
    """The one-card convert phase in a child process that owns the card."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "chip_smoke.py", "--phases", "convert"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"

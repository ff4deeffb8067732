"""Multi-process (DCN-path) execution of the distributed bootstrap and the
production sharded NMF.

The reference's only 'cluster tooling' is two scp scripts
(``push_to_server.sh``); this framework's replacement is
``parallel.distributed.initialize_multihost`` (jax.distributed over DCN) +
mesh collectives. These tests EXECUTE that path: two real OS processes form
a jax.distributed group over localhost (the same wire protocol a multi-host
pod uses — Gloo/GRPC coordination, cross-process collectives), each
contributing 4 virtual CPU devices to one 8-device mesh.

Run in subprocesses because jax.distributed can only be initialized once
per process and must happen before backend init — impossible inside the
already-initialized pytest process.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r'''
import os, sys, json
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
sys.path.insert(0, %(repo)r)
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental import multihost_utils
from exemplars_vc_tpu.parallel.distributed import initialize_multihost
from exemplars_vc_tpu.parallel.sharded_nmf import sharded_nmf_activations
from exemplars_vc_tpu.factorize import nmf_activations

info = initialize_multihost(coordinator_address=f"127.0.0.1:{port}",
                            num_processes=nproc, process_id=pid)
assert info["process_count"] == nproc
devs = np.array(jax.devices())
assert len(devs) == 4 * nproc, len(devs)

# 1) cross-process collective: global sum over a process-sharded array
mesh = Mesh(devs.reshape(nproc, 4), ("data", "dict"))
x = multihost_utils.host_local_array_to_global_array(
    np.full((4, 16), float(pid + 1), np.float32), mesh, P("data", None))
s = float(jax.jit(jnp.sum)(x))
expect = 64.0 * sum(range(1, nproc + 1))
assert abs(s - expect) < 1e-5, (s, expect)

# 2) the production sharded NMF with the dictionary axis spanning processes
mesh2 = Mesh(devs.reshape(1, 4 * nproc), ("data", "dict"))
rng = np.random.default_rng(0)                 # identical data every process
X = np.abs(rng.standard_normal((32, 201))).astype(np.float32)
A = np.abs(rng.standard_normal((512, 201))).astype(np.float32)
st = sharded_nmf_activations(jnp.asarray(X), jnp.asarray(A), mesh2,
                             tol=0.0, max_iter=60)
err_sharded = float(st.error)
err_local = float(nmf_activations(jnp.asarray(X), jnp.asarray(A),
                                  tol=0.0, max_iter=60).error)
assert abs(err_sharded - err_local) < 1e-3 * max(err_local, 1.0), (
    err_sharded, err_local)
if pid == 0:
    print(json.dumps({"psum": s, "sharded_err": err_sharded,
                      "local_err": err_local}))
''' % {"repo": REPO}


CONVERT_WORKER = r'''
import os, sys, json, tempfile
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
sys.path.insert(0, %(repo)r)
import numpy as np
from dataclasses import replace
from exemplars_vc_tpu.parallel.distributed import initialize_multihost
from exemplars_vc_tpu.config import load_config
from exemplars_vc_tpu.io import ArtifactStore
from exemplars_vc_tpu.io.synth_corpus import write_corpus
from exemplars_vc_tpu.pipelines.convert import convert_utterance
from exemplars_vc_tpu.pipelines.evaluate import heldout_pair

info = initialize_multihost(coordinator_address=f"127.0.0.1:{port}",
                            num_processes=nproc, process_id=pid)
assert info["process_count"] == nproc and len(jax.devices()) == 4 * nproc

cfg = load_config(overrides=["data.tar=TF1", "misc.nb_file=2"])
cfg_sh = replace(cfg, nmf=replace(cfg.nmf, solver="mu_sharded",
                                  max_iter=10, tol=0.0))
cfg_mu = replace(cfg_sh, nmf=replace(cfg_sh.nmf, solver="mu"))
with tempfile.TemporaryDirectory() as tmp:
    # both workers write the same seeded corpus into their own directory
    data_root = write_corpus(os.path.join(tmp, "corpus"), seed=0,
                             n_pairs=2, min_s=1.0, max_s=1.0)
    wav, _ = heldout_pair(data_root)
    # the production composition: dictionary sharded over the GLOBAL
    # 2-process x 4-device mesh, psum riding the (localhost) DCN group
    res_sh = convert_utterance(cfg_sh, ArtifactStore(os.path.join(tmp, "a")),
                               data_root, wav, nb_file=2, synth_iters=2)
    # single-process reference inside the same worker (local devices only)
    res_mu = convert_utterance(cfg_mu, ArtifactStore(os.path.join(tmp, "b")),
                               data_root, wav, nb_file=2, synth_iters=2)
Y_sh = np.asarray(res_sh.converted["stft"], np.float64)
Y_mu = np.asarray(res_mu.converted["stft"], np.float64)
assert np.isfinite(res_sh.audio).all()
dY = float(np.abs(Y_sh - Y_mu).max() / max(np.abs(Y_mu).max(), 1e-12))
assert dY <= 2e-3, dY
print(json.dumps({"pid": pid, "dY": dY,
                  "audio_sum": float(np.abs(res_sh.audio).sum()),
                  "y_sum": float(Y_sh.sum())}))
''' % {"repo": REPO}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(240)
def test_two_process_distributed_sharded_nmf(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = str(_free_port())
    env = dict(os.environ)
    # the workers set their own platform/XLA flags before importing jax
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, str(worker), str(pid), "2", port],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=str(tmp_path))
             for pid in (0, 1)]
    outs = [p.communicate(timeout=220) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-2000:]}"
    import json

    payload = json.loads(outs[0][0].strip().splitlines()[-1])
    assert payload["psum"] == 192.0
    assert abs(payload["sharded_err"] - payload["local_err"]) < 1e-2


@pytest.mark.timeout(600)
def test_two_process_production_convert(tmp_path):
    """The COMPOSED production pipeline cross-process:
    convert_utterance with nmf.solver=mu_sharded, the dictionary axis
    spanning a real 2-process jax.distributed group, must produce the same
    conversion as the single-process mu solver — and identically on both
    workers."""
    worker = tmp_path / "worker.py"
    worker.write_text(CONVERT_WORKER)
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, str(worker), str(pid), "2", port],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=str(tmp_path))
             for pid in (0, 1)]
    outs = [p.communicate(timeout=580) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-3000:]}"
    import json

    payloads = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    # both processes converged to the same audio (bitwise deterministic
    # pipeline over the shared mesh) and matched their local mu reference
    assert payloads[0]["y_sum"] == payloads[1]["y_sum"], payloads
    assert payloads[0]["audio_sum"] == payloads[1]["audio_sum"], payloads
    assert max(p["dY"] for p in payloads) <= 2e-3

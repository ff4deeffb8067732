import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exemplars_vc_tpu.align import dtw_batch
from exemplars_vc_tpu.factorize import nmf_activations
from exemplars_vc_tpu.parallel import (
    initialize_multihost,
    make_mesh,
    sharded_dtw_batch,
    sharded_nmf_activations,
)
from exemplars_vc_tpu.parallel.mesh import replicate, shard_batch


def test_mesh_shapes():
    mesh = make_mesh()
    assert mesh.shape["data"] == 8 and mesh.shape["dict"] == 1
    mesh2 = make_mesh(data=2, dict_=4)
    assert mesh2.shape["data"] == 2 and mesh2.shape["dict"] == 4
    with pytest.raises(ValueError):
        make_mesh(data=3, dict_=3)  # 9 > 8 devices
    # an axis larger than the device count must raise (floor-division used
    # to produce a 0-sized axis and an empty mesh)
    with pytest.raises(ValueError):
        make_mesh(dict_=16)
    with pytest.raises(ValueError):
        make_mesh(data=16)
    # sub-meshes over a device subset are allowed
    assert make_mesh(data=2, dict_=1).devices.size == 2


def test_sharded_solvers_reuse_jitted_executables():
    """Repeated same-shape calls must reuse one jitted executable (a fresh
    jit wrapper per call recompiles every invocation)."""
    from exemplars_vc_tpu.parallel import sharded_nmf as sn

    mesh = make_mesh(data=1, dict_=4)
    fn1 = sn._jitted_solver(mesh, "dict", 1e-4, 30, 10)
    fn2 = sn._jitted_solver(mesh, "dict", 1e-4, 30, 10)
    assert fn1 is fn2

    from exemplars_vc_tpu.parallel import sharded_dtw as sd

    mesh2 = make_mesh(data=4, dict_=1)
    assert sd._jitted_batch(mesh2, "data") is sd._jitted_batch(mesh2, "data")


def test_sharded_nmf_remainder_iterations():
    """max_iter not divisible by check_every runs the remainder, matching
    the single-device solver's n_iter."""
    rng = np.random.default_rng(0)
    X = jnp.asarray(np.abs(rng.standard_normal((12, 10))), jnp.float32)
    A = jnp.asarray(np.abs(rng.standard_normal((16, 10))), jnp.float32)
    mesh = make_mesh(data=1, dict_=4)
    st_sh = sharded_nmf_activations(X, A, mesh, tol=0.0, max_iter=25)
    st_1d = nmf_activations(X, A, tol=0.0, max_iter=25)
    assert int(st_sh.n_iter) == int(st_1d.n_iter) == 25
    np.testing.assert_allclose(np.asarray(st_sh.H), np.asarray(st_1d.H),
                               rtol=2e-4, atol=1e-6)


def test_shard_and_replicate():
    mesh = make_mesh(data=4, dict_=2)
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    xs = shard_batch(x, mesh)
    np.testing.assert_array_equal(np.asarray(xs), x)
    xr = replicate(x, mesh)
    np.testing.assert_array_equal(np.asarray(xr), x)


def test_sharded_nmf_matches_single_device():
    rng = np.random.default_rng(0)
    F, K, D = 24, 64, 16
    A = np.abs(rng.standard_normal((K, D))).astype(np.float32)
    X = np.abs(rng.standard_normal((F, D))).astype(np.float32)
    ref = nmf_activations(jnp.asarray(X), jnp.asarray(A), tol=0.0, max_iter=50)

    mesh = make_mesh(data=2, dict_=4)
    st = sharded_nmf_activations(jnp.asarray(X), jnp.asarray(A), mesh,
                                 tol=0.0, max_iter=50)
    np.testing.assert_allclose(np.asarray(st.H), np.asarray(ref.H), rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(float(st.error), float(ref.error), rtol=1e-3)


def test_sharded_nmf_early_stop():
    rng = np.random.default_rng(1)
    A = np.abs(rng.standard_normal((32, 8))).astype(np.float32)
    X = np.abs(rng.standard_normal((10, 8))).astype(np.float32)
    mesh = make_mesh(data=1, dict_=8)
    st = sharded_nmf_activations(jnp.asarray(X), jnp.asarray(A), mesh,
                                 tol=1e-1, max_iter=150)
    assert int(st.n_iter) < 150


def test_sharded_dtw_matches_single_device():
    rng = np.random.default_rng(2)
    N, T, D = 8, 36, 5
    fa = rng.standard_normal((N, T, D)).astype(np.float32)
    fb = rng.standard_normal((N, T, D)).astype(np.float32)
    la = rng.integers(10, T, N).astype(np.int32)
    lb = rng.integers(10, T, N).astype(np.int32)
    ref = dtw_batch(jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(la), jnp.asarray(lb))

    mesh = make_mesh(data=8, dict_=1)
    r = sharded_dtw_batch(fa, fb, la, lb, mesh)
    np.testing.assert_allclose(np.asarray(r.raw_distance), np.asarray(ref.raw_distance), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(r.path_len), np.asarray(ref.path_len))
    np.testing.assert_array_equal(np.asarray(r.path_i), np.asarray(ref.path_i))


def test_initialize_multihost_single_process():
    info = initialize_multihost()
    assert info["process_count"] == 1
    assert info["global_devices"] == 8


def test_batch_sharded_nsgt_matches_single_device():
    """Corpus-scale NSGT analysis: signal batch sharded over the data axis of
    the mesh must reproduce the single-device transform exactly."""
    from exemplars_vc_tpu.dsp.nsgt import insgt, nsgt

    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, 2560)).astype(np.float32)
    want = np.asarray(nsgt(jnp.asarray(x), sr=16000, fmin=150.0))

    mesh = make_mesh(data=8, dict_=1)
    xs = shard_batch(x, mesh)
    got_c = jax.jit(lambda s: nsgt(s, sr=16000, fmin=150.0))(xs)
    np.testing.assert_allclose(np.asarray(got_c), want, atol=1e-5)
    back = np.asarray(jax.jit(lambda c: insgt(c, 2560, sr=16000, fmin=150.0))(got_c))
    np.testing.assert_allclose(back, x, atol=1e-3)

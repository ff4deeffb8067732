"""Training loop for the neural warping net (stage 02).

Re-designs ``02_freq_warping_neural.py:121-246``: L1 loss (summed, the
reference's ``L1Loss(size_average=False)`` — ``:149``), RMSprop(lr=5e-3,
weight_decay=1e-4) (``:150``), nb_epoch epochs, held-out 20% eval each epoch,
best-average-loss checkpointing and patience early stopping (``:222-242``).

Accelerator-first: instead of one python-level optimizer step per utterance with
host↔device transfers each iteration, utterances are padded/masked into a
single device batch and every epoch is a handful of jitted update steps; the
batch axis is the data-parallel axis over a mesh.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax

from exemplars_vc_tpu.align.exemplar import gather_aligned_batch
from exemplars_vc_tpu.config import Config
from exemplars_vc_tpu.io import ArtifactStore
from exemplars_vc_tpu.models.warping import (
    WarpingNetConfig,
    init_warping_params,
    warping_forward_batch,
)
from exemplars_vc_tpu.obs import Timer, get_logger
from exemplars_vc_tpu.pipelines.make_dict import make_dictionary


def make_warping_dataset(cfg: Config, store: ArtifactStore, data_path: str,
                         nb_file: int | None = None, features: str = "dict"):
    """Aligned (source, target) frame sequences from the exemplar dictionary —
    the training pairs the reference loads from ``SF12TM3_*.pkl``
    (``02_freq_warping_neural.py:257-260``).

    ``features="dict"`` (reference semantics) trains on the dictionary
    features themselves (MFCC). Any other value names a conversion feature
    ("stft", "sp", …): the same DTW paths gather that feature's per-utterance
    sequences instead, producing aligned SPECTRAL pairs — the training set
    for direct neural conversion (beyond the reference, whose eval script
    for this path was left broken)."""
    art = make_dictionary(cfg, store, data_path, nb_file=nb_file)
    if features == "dict":
        fa, fb = jnp.asarray(art.feat_a), jnp.asarray(art.feat_b)
    else:
        from exemplars_vc_tpu.pipelines.conv_dicts import build_conversion_dicts

        sf = build_conversion_dicts(cfg, store, data_path, cfg.data.src,
                                    nb_file=nb_file)
        tf_ = build_conversion_dicts(cfg, store, data_path, cfg.data.tar,
                                     nb_file=nb_file)
        fa = jnp.asarray(sf.feats[features])
        fb = jnp.asarray(tf_.feats[features])
        # the DTW paths index the dictionary-feature frame grid; conversion
        # features are extracted at the same hop, so the grids agree
        max_idx = int(np.asarray(art.path_i).max())
        assert max_idx < fa.shape[1], \
            f"alignment grid ({max_idx}) exceeds " \
            f"{features} frames ({fa.shape[1]})"
    src = gather_aligned_batch(fa, jnp.asarray(art.path_i))
    tar = gather_aligned_batch(fb, jnp.asarray(art.path_j))
    # paths may be device-resident on a fresh build — materialize once so
    # the returned mask is host numpy either way
    mask = (np.asarray(art.path_i) >= 0).astype(np.float32)
    return np.asarray(src), np.asarray(tar), mask


def train_test_split(n: int, test_size: float = 0.2, seed: int = 10):
    """Index split mirroring the reference's sklearn call
    (``utils.py:109``: test_size=0.2, random_state=10)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_test = max(1, int(round(n * test_size)))
    return perm[n_test:], perm[:n_test]


def reference_rmsprop(learning_rate: float, weight_decay: float):
    """RMSprop with the reference's exact torch semantics
    (``02_freq_warping_neural.py:150``: ``optim.RMSprop(lr=5e-3,
    weight_decay=1e-4)``, torch defaults alpha=0.99, eps=1e-8): coupled L2
    (wd·p added to the gradient BEFORE the squared-average update), running
    average decay 0.99, and eps added OUTSIDE the sqrt. One-step trajectory
    parity vs torch is asserted in tests/test_torch_golden.py."""
    return optax.chain(
        optax.add_decayed_weights(weight_decay),
        optax.rmsprop(learning_rate=learning_rate, decay=0.99,
                      eps=1e-8, eps_in_sqrt=False),
    )


@partial(jax.jit, static_argnames=("optimizer",))
def _update(params, opt_state, x, y, mask, optimizer):
    def loss_fn(p):
        pred = warping_forward_batch(p, x)
        l1 = jnp.abs(pred - y) * mask[..., None]
        return jnp.sum(l1)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss


@jax.jit
def _eval_loss(params, x, y, mask):
    pred = warping_forward_batch(params, x)
    return jnp.sum(jnp.abs(pred - y) * mask[..., None])


def save_params(store: ArtifactStore, name: str, params, backend: str = "npz") -> None:
    """Persist a parameter pytree.

    backend="npz" (default): flat-leaf arrays in the artifact store — simple,
    resumable, dependency-free. backend="orbax": a StandardCheckpointer
    directory under the store root for ecosystem interop (async-capable,
    sharding-aware)."""
    if backend == "orbax":
        import orbax.checkpoint as ocp

        path = os.path.abspath(os.path.join(store.root, f"{name}_orbax"))
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(path, params, force=True)
        ckptr.wait_until_finished()
        return
    leaves, treedef = jax.tree_util.tree_flatten(params)
    store.save(name, **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)})
    store.save_json(name + "_meta", {"n_leaves": len(leaves)})


def load_params(store: ArtifactStore, name: str, like, backend: str = "npz") -> dict:
    if backend == "orbax":
        import orbax.checkpoint as ocp

        path = os.path.abspath(os.path.join(store.root, f"{name}_orbax"))
        return ocp.StandardCheckpointer().restore(path, like)
    z = store.load(name)
    leaves = [jnp.asarray(z[f"leaf_{i}"]) for i in range(len(z))]
    treedef = jax.tree_util.tree_structure(like)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def train_warping_net(
    cfg: Config,
    store: ArtifactStore,
    data_path: str,
    nb_file: int | None = None,
    run_root: str | None = None,
    seed: int = 0,
    data_parallel: bool = False,
    features: str = "dict",
) -> dict:
    """Train the warping net. With ``data_parallel=True`` and multiple
    devices, minibatches are sharded over the mesh ``data`` axis (parameters
    replicated; XLA all-reduces the gradients) — the multi-chip training path
    exercised by __graft_entry__.dryrun_multichip.

    ``features`` other than "dict" trains on that aligned CONVERSION feature
    (e.g. "stft") — direct neural conversion; in/out sizes then come from
    the data, and the checkpoint/normalization artifacts get a
    feature-suffixed name so the reference-parity MFCC net is untouched."""
    log = get_logger()
    src, tar, mask = make_warping_dataset(cfg, store, data_path,
                                          nb_file=nb_file, features=features)
    idx_train, idx_test = train_test_split(src.shape[0])
    log.info("warping dataset (%s): %d train / %d test utterances, T=%d",
             features, len(idx_train), len(idx_test), src.shape[1])

    io_size = cfg.net.in_size if features == "dict" else src.shape[2]
    out_size = cfg.net.out_size if features == "dict" else tar.shape[2]
    net_cfg = WarpingNetConfig(
        in_size=io_size, hidden_size=cfg.net.hidden_size,
        out_size=out_size, nb_lstm_layers=cfg.net.nb_lstm_layers,
        bidirectional=cfg.net.bidirectional,
    )
    params = init_warping_params(jax.random.PRNGKey(seed), net_cfg)

    optimizer = reference_rmsprop(cfg.net.learning_rate, cfg.net.weight_decay)
    opt_state = optimizer.init(params)

    # Standardize features with masked training-set statistics (the reference
    # trains on raw MFCCs whose c0 is O(500) — with lr 5e-3 the net cannot
    # even reach the identity baseline; normalization fixes conditioning and
    # the stats are stored with the checkpoint for inference).
    m3 = mask[idx_train][..., None]
    denom = max(m3.sum(), 1.0)
    mu = (src[idx_train] * m3).sum((0, 1)) / denom
    sd = np.sqrt(((src[idx_train] - mu) ** 2 * m3).sum((0, 1)) / denom) + 1e-6
    feat_tag = "" if features == "dict" else f"_{features}"
    store.save(f"warping_norm{feat_tag}", mu=mu, sd=sd)

    def norm(a):
        return (a - mu) / sd

    xs_tr = jnp.asarray(norm(src[idx_train]))
    ys_tr = jnp.asarray(norm(tar[idx_train]))
    m_tr = jnp.asarray(mask[idx_train])
    xs_te = jnp.asarray(norm(src[idx_test]))
    ys_te = jnp.asarray(norm(tar[idx_test]))
    m_te = jnp.asarray(mask[idx_test])

    from exemplars_vc_tpu.obs.logging import new_run_dir
    from exemplars_vc_tpu.obs.scalars import ScalarWriter

    run_dir = new_run_dir(run_root or os.path.join(store.root, "runs"))
    writer = ScalarWriter(run_dir)

    best_loss, best_epoch, stale = np.inf, -1, 0
    history = []
    ckpt_name = f"{cfg.net.checkpoint_name}_warping{feat_tag}"
    n_train = xs_tr.shape[0]
    # minibatch of batch_size utterances per step (reference: one optimizer
    # step per utterance per epoch, 02_freq_warping_neural.py:161-191)
    mb = max(1, cfg.net.batch_size)

    if data_parallel and len(jax.devices()) > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from exemplars_vc_tpu.parallel import make_mesh

        n_dev = len(jax.devices())
        mesh = make_mesh(data=n_dev, dict_=1)
        # minibatch must fill the data axis; round UP to a device multiple
        mb = ((max(mb, n_dev) + n_dev - 1) // n_dev) * n_dev
        batch_sharding = NamedSharding(mesh, P("data", None, None))
        repl = NamedSharding(mesh, P())
        params = jax.device_put(params, repl)
        opt_state = jax.device_put(opt_state, repl)

        def place_batch(x, y, m):
            return (jax.device_put(x, batch_sharding),
                    jax.device_put(y, batch_sharding),
                    jax.device_put(m, NamedSharding(mesh, P("data", None))))
    else:
        def place_batch(x, y, m):
            return x, y, m
    rng = np.random.default_rng(seed + 1)
    steps_run = 0
    with Timer("train") as t_total:
        for epoch in range(cfg.net.nb_epoch):
            order = rng.permutation(n_train)
            tr_loss = 0.0
            for s in range(0, n_train, mb):
                idx = order[s : s + mb]
                if len(idx) < mb:
                    # keep the true tail samples, then wrap from the start
                    # (cycling if mb > n_train) so sharded shapes stay fixed
                    idx = np.concatenate([idx, np.resize(order, mb - len(idx))])
                sel = jnp.asarray(idx)
                bx, by, bm = place_batch(xs_tr[sel], ys_tr[sel], m_tr[sel])
                params, opt_state, loss = _update(
                    params, opt_state, bx, by, bm, optimizer
                )
                tr_loss += float(loss)
                steps_run += 1
            te_loss = float(_eval_loss(params, xs_te, ys_te, m_te))
            per_frame = te_loss / max(float(m_te.sum()), 1.0)
            history.append({"epoch": epoch, "train_loss": float(tr_loss),
                            "test_loss": te_loss, "test_l1_per_frame": per_frame})
            # per-epoch scalars + per-parameter summaries (the reference's
            # tensorboardX add_scalar/add_histogram, 02_freq_warping_neural.py:212-220)
            writer.scalar("loss/train", float(tr_loss), epoch)
            writer.scalar("loss/test", te_loss, epoch)
            for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
                writer.summary(f"params/leaf_{i}", np.asarray(leaf), epoch)
            log.info("epoch %d: train %.1f test %.1f (%.4f/frame)",
                     epoch, float(tr_loss), te_loss, per_frame)
            if te_loss < best_loss:   # best-loss checkpointing (ref :222-235)
                best_loss, best_epoch, stale = te_loss, epoch, 0
                save_params(store, ckpt_name, params)
            else:
                stale += 1
                if stale >= cfg.net.patience:  # early stop (ref :238-240)
                    log.info("early stop at epoch %d (patience %d)",
                             epoch, cfg.net.patience)
                    break

    writer.close()
    return {
        "epochs_run": len(history),
        "best_epoch": best_epoch,
        "best_test_loss": float(best_loss),
        "final_test_l1_per_frame": history[-1]["test_l1_per_frame"],
        "train_seconds": t_total.elapsed,
        # training-throughput telemetry (BASELINE eval config 4): optimizer
        # steps and epochs per wall second, and the wall time to the best
        # checkpoint — the reference trains one step per utterance per epoch
        # with no timing at all (02_freq_warping_neural.py:161-191)
        "steps_run": steps_run,
        "steps_per_s": round(steps_run / max(t_total.elapsed, 1e-9), 2),
        "epochs_per_s": round(len(history) / max(t_total.elapsed, 1e-9), 3),
        "seconds_to_best": round(
            t_total.elapsed * (best_epoch + 1) / max(len(history), 1), 2),
        "minibatch_utterances": mb,
        "checkpoint": ckpt_name,
        "run_dir": run_dir,
        "history": history,
    }


def apply_warping_net(store: ArtifactStore, cfg: Config, feats: jnp.ndarray,
                      features: str = "dict") -> jnp.ndarray:
    """Inference path (the reference's unfinished ``02_test_freq_warping_neural``):
    load the best checkpoint (+ normalization stats) and warp feature
    sequences. ``features`` selects the feature-suffixed checkpoint trained
    by :func:`train_warping_net` (e.g. "stft" for the spectral net)."""
    feat_tag = "" if features == "dict" else f"_{features}"
    if store.has(f"warping_norm{feat_tag}"):
        z = store.load(f"warping_norm{feat_tag}")
        mu, sd = jnp.asarray(z["mu"]), jnp.asarray(z["sd"])
    else:
        mu, sd = 0.0, 1.0
    feats = (feats - mu) / sd
    io_size = cfg.net.in_size if features == "dict" else feats.shape[-1]
    out_size = cfg.net.out_size if features == "dict" else feats.shape[-1]
    net_cfg = WarpingNetConfig(
        in_size=io_size, hidden_size=cfg.net.hidden_size,
        out_size=out_size, nb_lstm_layers=cfg.net.nb_lstm_layers,
        bidirectional=cfg.net.bidirectional,
    )
    like = init_warping_params(jax.random.PRNGKey(0), net_cfg)
    params = load_params(store, f"{cfg.net.checkpoint_name}_warping{feat_tag}", like)
    return warping_forward_batch(params, feats) * sd + mu

"""The neural frequency-warping net as a scan-based LSTM in pure JAX.

Re-designs the reference's ``models.Net`` (``models.py:59-100``): a 2-layer
unidirectional LSTM (20→20) whose per-frame output goes through one linear
head ``fc4: Linear(hidden→out)`` (the fc1/fc2/fc3 MLP heads exist but are
bypassed in the reference forward — ``models.py:83-87``; we keep the same
effective architecture and expose the deep head as an option).

Accelerator-first: time recurrence is one ``lax.scan`` whose step does a single fused
(4H × (in+H)) matmul per layer; utterance batching via ``vmap`` with masks, so
the whole training set can run as one device batch instead of the reference's
per-utterance python loop (``02_freq_warping_neural.py:161-191``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class WarpingNetConfig:
    in_size: int = 20
    hidden_size: int = 20
    out_size: int = 20
    nb_lstm_layers: int = 2
    bidirectional: bool = False  # the reference's config knob (config/config:15)
                                 # which its Net hard-codes off (models.py:72)
    deep_head: bool = False     # use the fc1→fc2→fc3 MLP head instead of fc4
    fc_neurons: int = 1024      # reference models.py:60 fc_neuron default


def init_warping_params(key: jax.Array, cfg: WarpingNetConfig) -> dict:
    """Parameter pytree. LSTM weights per layer: W (in+H, 4H), b (4H,) with
    gate order [i, f, g, o]; forget-gate bias starts at 1 (standard practice;
    torch inits biases uniformly — documented deviation)."""
    params: dict = {"lstm": [], "head": {}}
    h = cfg.hidden_size
    n_dir = 2 if cfg.bidirectional else 1
    for layer in range(cfg.nb_lstm_layers):
        d_in = (cfg.in_size if layer == 0 else h * n_dir)
        scale = 1.0 / jnp.sqrt(h)
        dirs = {}
        for direction in (["fwd", "bwd"] if cfg.bidirectional else ["fwd"]):
            key, k1 = jax.random.split(key)
            W = jax.random.uniform(k1, (d_in + h, 4 * h), minval=-scale, maxval=scale)
            b = jnp.zeros((4 * h,)).at[h : 2 * h].set(1.0)
            dirs[direction] = {"W": W, "b": b}
        params["lstm"].append(dirs)
    key, k1, k2, k3, k4 = jax.random.split(key, 5)
    h_out = h * n_dir   # head consumes the (possibly concatenated) LSTM output
    if cfg.deep_head:
        s1 = 1.0 / jnp.sqrt(h_out)
        s2 = 1.0 / jnp.sqrt(cfg.fc_neurons)
        params["head"] = {
            "fc1": {"W": jax.random.uniform(k1, (h_out, cfg.fc_neurons), minval=-s1, maxval=s1),
                    "b": jnp.zeros((cfg.fc_neurons,))},
            "fc2": {"W": jax.random.uniform(k2, (cfg.fc_neurons, cfg.fc_neurons), minval=-s2, maxval=s2),
                    "b": jnp.zeros((cfg.fc_neurons,))},
            "fc3": {"W": jax.random.uniform(k3, (cfg.fc_neurons, cfg.out_size), minval=-s2, maxval=s2),
                    "b": jnp.zeros((cfg.out_size,))},
        }
    else:
        s = 1.0 / jnp.sqrt(h_out)
        params["head"] = {
            "fc4": {"W": jax.random.uniform(k4, (h_out, cfg.out_size), minval=-s, maxval=s),
                    "b": jnp.zeros((cfg.out_size,))},
        }
    return params


def _lstm_layer(layer_params, xs):
    """(T, d_in) → (T, H) via lax.scan; one fused gate matmul per step."""
    W, b = layer_params["W"], layer_params["b"]
    hidden = W.shape[1] // 4

    def step(carry, x_t):
        h, c = carry
        gates = jnp.concatenate([x_t, h]) @ W + b
        i, f, g, o = jnp.split(gates, 4)
        i, f, o = jax.nn.sigmoid(i), jax.nn.sigmoid(f), jax.nn.sigmoid(o)
        g = jnp.tanh(g)
        c = f * c + i * g
        h = o * jnp.tanh(c)
        return (h, c), h

    init = (jnp.zeros((hidden,), xs.dtype), jnp.zeros((hidden,), xs.dtype))
    _, hs = jax.lax.scan(step, init, xs)
    return hs


def warping_forward(params: dict, x: jnp.ndarray) -> jnp.ndarray:
    """(T, in_size) → (T, out_size)."""
    h = x
    for layer_params in params["lstm"]:
        fwd = _lstm_layer(layer_params["fwd"], h)
        if "bwd" in layer_params:
            bwd = _lstm_layer(layer_params["bwd"], h[::-1])[::-1]
            h = jnp.concatenate([fwd, bwd], axis=-1)
        else:
            h = fwd
    head = params["head"]
    if "fc4" in head:
        return h @ head["fc4"]["W"] + head["fc4"]["b"]
    h = jnp.tanh(h @ head["fc1"]["W"] + head["fc1"]["b"])
    h = jnp.tanh(h @ head["fc2"]["W"] + head["fc2"]["b"])
    return h @ head["fc3"]["W"] + head["fc3"]["b"]


@jax.jit
def warping_forward_batch(params: dict, x: jnp.ndarray) -> jnp.ndarray:
    """(N, T, in_size) → (N, T, out_size)."""
    return jax.vmap(partial(warping_forward, params))(x)

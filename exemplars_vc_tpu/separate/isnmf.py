"""Itakura-Saito NMF multiplicative updates (plain and source/filter).

Batched re-design of the reference's vendored pyfasst NMF tools
(``dependencies/pyfasst-master/pyfasst/tools/nmf.py``):

- ``NMF_decomposition`` / ``NMF_decomp_init`` (``tools/nmf.py:24-159``):
  IS-divergence multiplicative updates on a power spectrogram SX ≈ W·H,
  with optional provided inits and per-factor update switches, W columns
  normalized to sum 1 after each W update (energy shipped into H).
- ``SFNMF_decomp_init`` (``tools/nmf.py:161-360``): the Durrieu
  source/filter model SX ≈ (W·H) ⊙ (WFilt·HFilt) + Wres·Hres with the same
  multiplicative-update/normalization schedule.

Here the whole iteration is one ``lax.fori_loop`` of fused matmuls
under jit (the reference loops in numpy on host); orientation is
(F, K)·(K, N) throughout — no transposed-storage tricks, XLA lays out the
operands. eps matches pyfasst (1e-10).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_EPS = 1e-10  # pyfasst tools/nmf.py:22


def is_divergence(SX: jnp.ndarray, SX_hat: jnp.ndarray) -> jnp.ndarray:
    """Itakura-Saito divergence D_IS(SX ‖ SX_hat), summed over all bins."""
    r = SX / jnp.maximum(SX_hat, _EPS)
    return jnp.sum(r - jnp.log(jnp.maximum(r, _EPS)) - 1.0)


def _update_W(SX, W, H):
    """One IS multiplicative update of W (H fixed), then column-normalize W
    and ship the energy into H — pyfasst ``tools/nmf.py:136-147``."""
    hatSX = jnp.dot(W, H, preferred_element_type=jnp.float32)
    num = jnp.dot(SX / jnp.maximum(hatSX * hatSX, _EPS), H.T,
                  preferred_element_type=jnp.float32)
    den = jnp.dot(1.0 / jnp.maximum(hatSX, _EPS), H.T,
                  preferred_element_type=jnp.float32)
    W = W * (num / jnp.maximum(den, _EPS))
    sumW = W.sum(axis=0)
    sumW = jnp.where(sumW == 0.0, 1.0, sumW)
    return W / sumW, H * sumW[:, None]


def _update_H(SX, W, H):
    """One IS multiplicative update of H (W fixed) — ``tools/nmf.py:149-157``."""
    hatSX = jnp.dot(W, H, preferred_element_type=jnp.float32)
    num = jnp.dot(W.T, SX / jnp.maximum(hatSX * hatSX, _EPS),
                  preferred_element_type=jnp.float32)
    den = jnp.dot(W.T, 1.0 / jnp.maximum(hatSX, _EPS),
                  preferred_element_type=jnp.float32)
    return H * (num / jnp.maximum(den, _EPS))


@partial(jax.jit, static_argnames=("n_iter", "update_W", "update_H"))
def _is_nmf_loop(SX, W0, H0, n_iter: int, update_W: bool, update_H: bool):
    # full-f32 matmuls: IS updates divide by v² — an accelerator's reduced
    # default matmul precision destabilizes them (see stereo_simm._stereo_simm_loop)
    with jax.default_matmul_precision("highest"):
        return _is_nmf_loop_body(SX, W0, H0, n_iter, update_W, update_H)


def _is_nmf_loop_body(SX, W0, H0, n_iter: int, update_W: bool, update_H: bool):
    def body(_, carry):
        W, H = carry
        if update_W:
            W, H = _update_W(SX, W, H)
        if update_H:
            H = _update_H(SX, W, H)
        return W, H

    return jax.lax.fori_loop(0, n_iter, body, (W0, H0))


def is_nmf(
    SX: jnp.ndarray,
    n_components: int = 10,
    n_iter: int = 10,
    key: jax.Array | None = None,
    W_init: jnp.ndarray | None = None,
    H_init: jnp.ndarray | None = None,
    update_W: bool = True,
    update_H: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """IS-divergence NMF of a power spectrogram: SX (F, N) ≈ W (F, K) · H (K, N).

    Semantics follow pyfasst ``NMF_decomp_init`` (``tools/nmf.py:63-159``):
    random squared-normal inits where not provided, W column-normalized
    after each W update with the scale shipped into H, per-factor update
    switches for warm-starting structured models. Update order per
    iteration: W then H, each against a freshly computed reconstruction.
    """
    F, N = SX.shape
    if key is None:
        key = jax.random.PRNGKey(0)
    kw, kh = jax.random.split(key)
    W = (jax.random.normal(kw, (F, n_components)) ** 2
         if W_init is None else jnp.asarray(W_init, jnp.float32))
    H = (jax.random.normal(kh, (n_components, N)) ** 2
         if H_init is None else jnp.asarray(H_init, jnp.float32))
    if update_W:  # tools/nmf.py:130-131
        W = W / W.sum(axis=0)
    SX = jnp.asarray(SX, jnp.float32)
    return _is_nmf_loop(SX, W.astype(jnp.float32), H.astype(jnp.float32),
                        n_iter, update_W, update_H)


@partial(
    jax.jit,
    static_argnames=(
        "n_iter", "update_W", "update_H", "update_W_filt", "update_H_filt",
        "update_res",
    ),
)
def _sf_nmf_loop(
    SX, W0, H0, WF0, HF0, WR0, HR0,
    n_iter: int, update_W: bool, update_H: bool,
    update_W_filt: bool, update_H_filt: bool, update_res: bool = True,
):
    # full-f32 matmuls — see _is_nmf_loop
    with jax.default_matmul_precision("highest"):
        return _sf_nmf_loop_body(SX, W0, H0, WF0, HF0, WR0, HR0, n_iter,
                                 update_W, update_H, update_W_filt,
                                 update_H_filt, update_res)


def _sf_nmf_loop_body(
    SX, W0, H0, WF0, HF0, WR0, HR0,
    n_iter: int, update_W: bool, update_H: bool,
    update_W_filt: bool, update_H_filt: bool, update_res: bool = True,
):
    def recon(W, H, WF, HF, WR, HR):
        SF0 = jnp.dot(W, H, preferred_element_type=jnp.float32)
        SPHI = jnp.dot(WF, HF, preferred_element_type=jnp.float32)
        Sres = jnp.dot(WR, HR, preferred_element_type=jnp.float32)
        return SF0, SPHI, Sres, SF0 * SPHI + Sres

    def body(_, carry):
        W, H, WF, HF, WR, HR = carry

        if update_W:  # tools/nmf.py:234-254
            _, SPHI, _, hatSX = recon(W, H, WF, HF, WR, HR)
            num = jnp.dot(SX * SPHI / jnp.maximum(hatSX * hatSX, _EPS), H.T)
            den = jnp.dot(SPHI / jnp.maximum(hatSX, _EPS), H.T)
            W = W * (num / jnp.maximum(den, _EPS))
            sumW = W.sum(axis=0)
            sumW = jnp.where(sumW == 0.0, 1.0, sumW)
            W, H = W / sumW, H * sumW[:, None]

        if update_H:  # tools/nmf.py:256-268
            _, SPHI, _, hatSX = recon(W, H, WF, HF, WR, HR)
            num = jnp.dot(W.T, SX * SPHI / jnp.maximum(hatSX * hatSX, _EPS))
            den = jnp.dot(W.T, SPHI / jnp.maximum(hatSX, _EPS))
            H = H * (num / jnp.maximum(den, _EPS))

        if update_W_filt:  # tools/nmf.py:276-298
            SF0, _, _, hatSX = recon(W, H, WF, HF, WR, HR)
            num = jnp.dot(SX * SF0 / jnp.maximum(hatSX * hatSX, _EPS), HF.T)
            den = jnp.dot(SF0 / jnp.maximum(hatSX, _EPS), HF.T)
            WF = WF * (num / jnp.maximum(den, _EPS))
            sumW = WF.sum(axis=0)
            sumW = jnp.where(sumW == 0.0, 1.0, sumW)
            WF, HF = WF / sumW, HF * sumW[:, None]

        if update_H_filt:  # tools/nmf.py:300-327
            SF0, _, _, hatSX = recon(W, H, WF, HF, WR, HR)
            num = jnp.dot(WF.T, SX * SF0 / jnp.maximum(hatSX * hatSX, _EPS))
            den = jnp.dot(WF.T, SF0 / jnp.maximum(hatSX, _EPS))
            HF = HF * (num / jnp.maximum(den, _EPS))
            # per-frame renormalization of the filter activations, energy → H
            sumH = HF.sum(axis=0)
            H = H * sumH[None, :]
            sumH = jnp.where(sumH == 0.0, 1.0, sumH)
            HF = HF / sumH[None, :]

        # residual components — pyfasst updates them every iteration
        # (tools/nmf.py:328-359); ``update_res=False`` freezes them (used by
        # the SIMM warm-up so the structured model claims its energy first)
        if update_res:
            _, _, _, hatSX = recon(W, H, WF, HF, WR, HR)
            num = jnp.dot(SX / jnp.maximum(hatSX * hatSX, _EPS), HR.T)
            den = jnp.dot(1.0 / jnp.maximum(hatSX, _EPS), HR.T)
            WR = WR * (num / jnp.maximum(den, _EPS))
            sumW = WR.sum(axis=0)
            sumW = jnp.where(sumW == 0.0, 1.0, sumW)
            WR, HR = WR / sumW, HR * sumW[:, None]

            _, _, _, hatSX = recon(W, H, WF, HF, WR, HR)
            num = jnp.dot(WR.T, SX / jnp.maximum(hatSX * hatSX, _EPS))
            den = jnp.dot(WR.T, 1.0 / jnp.maximum(hatSX, _EPS))
            HR = HR * (num / jnp.maximum(den, _EPS))

        return W, H, WF, HF, WR, HR

    return jax.lax.fori_loop(0, n_iter, body, (W0, H0, WF0, HF0, WR0, HR0))


def sf_nmf(
    SX: jnp.ndarray,
    n_components: int = 10,
    n_filt_components: int = 10,
    n_res_components: int = 2,
    n_iter: int = 10,
    key: jax.Array | None = None,
    W_init: jnp.ndarray | None = None,
    H_init: jnp.ndarray | None = None,
    W_filt_init: jnp.ndarray | None = None,
    H_filt_init: jnp.ndarray | None = None,
    W_res_init: jnp.ndarray | None = None,
    H_res_init: jnp.ndarray | None = None,
    update_W: bool = True,
    update_H: bool = True,
    update_W_filt: bool = True,
    update_H_filt: bool = True,
    update_res: bool = True,
):
    """Source/filter NMF: SX ≈ (W·H) ⊙ (WFilt·HFilt) + Wres·Hres.

    The Durrieu main-melody model as implemented by pyfasst
    ``SFNMF_decomp_init`` (``tools/nmf.py:161-360``): excitation dictionary
    W (e.g. harmonic combs) modulated by a smooth filter dictionary WFilt,
    plus a free residual term; IS-divergence multiplicative updates in the
    order W, H, WFilt, HFilt (with per-frame filter renormalization shipping
    energy into H), then the residual pair. Returns
    (W, H, WFilt, HFilt, Wres, Hres).
    """
    F, N = SX.shape
    if key is None:
        key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 6)

    def init(k, shape, provided, squared=True):
        if provided is not None:
            return jnp.asarray(provided, jnp.float32)
        g = jax.random.normal(k, shape)
        return (g ** 2 if squared else (1.0 + g) ** 2).astype(jnp.float32)

    W = init(ks[0], (F, n_components), W_init)
    H = init(ks[1], (n_components, N), H_init)
    WF = init(ks[2], (F, n_filt_components), W_filt_init)
    HF = init(ks[3], (n_filt_components, N), H_filt_init)
    WR = init(ks[4], (F, n_res_components), W_res_init, squared=False)
    HR = init(ks[5], (n_res_components, N), H_res_init, squared=False)
    if update_W:
        W = W / W.sum(axis=0)
    if update_W_filt:
        WF = WF / WF.sum(axis=0)

    return _sf_nmf_loop(
        jnp.asarray(SX, jnp.float32), W, H, WF, HF, WR, HR,
        n_iter, update_W, update_H, update_W_filt, update_H_filt, update_res,
    )

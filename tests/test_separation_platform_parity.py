"""Separation platform-robustness guards.

The SIMM-family fits minimize the IS divergence, which is chaotically
sensitive to near-silent spectrogram bins; float32 DEVICE STFTs differ
across platforms by ~1e-9 of the mean power exactly there, which drove an
accelerator's lead/accompaniment energy split to 1.8% vs 68% on CPU from
identical audio. The fix: the model-input spectrogram is computed HOST-side in
float64 (``separate/glue.py:host_stereo_powers`` / ``host_mean_power`` /
``host_stft_stack``) — as the reference's pyfasst does
(``dependencies/pyfasst-master/pyfasst/SeparateLeadStereo/
SeparateLeadStereoTF.py``, host float64 numpy) — making the fit inputs
platform-exact while the 40-iteration solve stays on device.

These tests pin (a) the host transforms against the device ``dsp.stft``
semantics, and (b) the end-to-end separation operating point on the bench
mixture, so a revert to device-side spectrograms (or a schedule change
that shifts the converged split) fails CI. The cross-PLATFORM certificate
itself is ``bench_separate.py --compare`` device-vs-CPU (lead_energy_share
equal on both).
"""

import numpy as np
import jax.numpy as jnp

from exemplars_vc_tpu.dsp.stft import stft
from exemplars_vc_tpu.separate import separate_lead_stereo
from exemplars_vc_tpu.separate.glue import (
    host_mean_power,
    host_stereo_powers,
    host_stft_stack,
)


def _mixture():
    import bench_separate

    return bench_separate.synthetic_mixture(return_components=True)


class TestHostTransforms:
    def test_host_stft_matches_device_stft(self):
        x, _, _ = _mixture()
        n_fft, hop = 512, 128
        Xh = np.asarray(jnp.abs(host_stft_stack(x, n_fft, hop, fnc=False)))
        Xd = np.asarray(jnp.abs(jnp.transpose(
            stft(jnp.asarray(x), n_fft=n_fft, hop_length=hop), (0, 2, 1))))
        assert Xh.shape == Xd.shape
        scale = np.abs(Xd).max()
        assert np.abs(Xh - Xd).max() / scale < 1e-5

    def test_host_powers_consistent_with_host_stft(self):
        x, _, _ = _mixture()
        n_fft, hop = 1024, 256
        SXR, SXL = host_stereo_powers(x, n_fft, hop)
        X = np.asarray(jnp.abs(host_stft_stack(x, n_fft, hop, fnc=False)))
        P = X.astype(np.float64) ** 2
        scale = 0.5 * (P[0].mean() + P[-1].mean())
        assert np.allclose(SXR, P[0] / scale, rtol=1e-4, atol=1e-6)
        assert np.allclose(SXL, P[-1] / scale, rtol=1e-4, atol=1e-6)
        SX = host_mean_power(x, n_fft, hop)
        assert np.allclose(SX, P.mean(axis=0), rtol=1e-4, atol=1e-9)

    def test_host_powers_deterministic(self):
        x, _, _ = _mixture()
        a = host_stereo_powers(x, 1024, 256)
        b = host_stereo_powers(x.copy(), 1024, 256)
        assert (a[0] == b[0]).all() and (a[1] == b[1]).all()


class TestOperatingPoint:
    def test_lead_energy_share_pinned(self):
        """The bench scenario's converged energy split (also the device-vs-CPU
        parity quantity; true share 0.647)."""
        import jax

        x, true_lead, true_acc = _mixture()
        res = separate_lead_stereo(
            jnp.asarray(x), sample_rate=16000.0, n_fft=1024, hop_length=256,
            f0_min=100.0, f0_max=800.0, n_accomp=20, n_iter=15,
            key=jax.random.PRNGKey(1))
        lead = np.asarray(res.lead, np.float64)
        accomp = np.asarray(res.accomp, np.float64)
        e_l, e_a = (lead ** 2).sum(), (accomp ** 2).sum()
        share = e_l / (e_l + e_a)
        assert abs(share - 0.676) < 0.05, share
        # decoded melody locks onto the 220 Hz vibrato lead
        f0 = res.f0[res.f0 > 0]
        assert len(f0) > 50 and abs(np.median(f0) - 220.0) < 10.0
        # the estimated lead resembles the true lead image
        T = lead.shape[-1]
        ref = true_lead[..., :T].astype(np.float64)
        sdr = 10 * np.log10((ref ** 2).sum()
                            / max(((lead - ref) ** 2).sum(), 1e-30))
        assert sdr > 3.0, sdr

"""Source separation — accelerator-native coverage of the reference's vendored
pyfasst toolbox (SURVEY §2.2).

The reference vendors pyfasst (``dependencies/pyfasst-master``) but never
imports it from the pipeline (verified in SURVEY §1); its capabilities are
nonetheless part of the component inventory. This package re-designs the
core of that toolbox Accelerator-first:

- ``isnmf``: Itakura-Saito NMF multiplicative updates with optional fixed
  factors (≙ ``pyfasst/tools/nmf.py:NMF_decomposition/NMF_decomp_init``)
  and the Durrieu source/filter variant (≙ ``SFNMF_decomp_init``).
- ``multichannel``: the FASST model family's core — EM for the local
  Gaussian model (per-source NMF spectral power × full-rank spatial
  covariance, Wiener-filter separation), jitted end-to-end
  (≙ ``pyfasst/audioModel.py:FASST/MultiChanNMFInst_FASST/MultiChanNMFConv``).

- ``hmm``: HMM/SHMM spectral-state models — one active spectral state per
  frame, Viterbi-decoded, count-based transition re-estimation
  (≙ ``MultiChanHMM``/``makeItHMM``/``makeItSHMM``).
- ``demix``: DEMIX anechoic mixing-direction clustering (pan angle + delay)
  with steering-vector / spatial-covariance init export (≙ ``demixTF.py``).
- ``lead``: SIMM lead/accompaniment separation — source/filter melody model,
  Viterbi melody tracking, two-pass estimation, Wiener resynthesis
  (≙ ``SeparateLeadStereo``/``SIMM``).

The Viterbi tracking kernel (pyfasst's only native extension) lives in
``align.viterbi``; melody-style f0 tracking built on it is
``world.f0.estimate_f0_tracked``.
"""

from exemplars_vc_tpu.separate.beamform import (
    apply_beamformer,
    directivity_diagram,
    mvdr_filter,
    ula_steering,
)
from exemplars_vc_tpu.separate.demix import DemixEstimate, demix
from exemplars_vc_tpu.separate.hmm import (
    HMMSpectra,
    fit_hmm_spectra,
    fit_multichannel_hmm,
    sticky_transition,
)
from exemplars_vc_tpu.separate.isnmf import is_nmf, is_divergence, sf_nmf
from exemplars_vc_tpu.separate.lead import (
    LeadSeparation,
    harmonic_dictionary,
    hann_filter_basis,
    separate_lead,
)
from exemplars_vc_tpu.separate.multichannel import (
    MultichannelNMF,
    fit_multichannel_nmf,
    separate_signal,
)
from exemplars_vc_tpu.separate.lead_multichannel import (
    MultichannelLead,
    MultichannelSF,
    fit_multichannel_sf,
    separate_lead_multichannel,
)
from exemplars_vc_tpu.separate.stereo_simm import (
    StereoLeadSeparation,
    StereoSIMM,
    separate_lead_stereo,
    stereo_simm,
)

__all__ = [
    "is_nmf",
    "is_divergence",
    "sf_nmf",
    "MultichannelNMF",
    "fit_multichannel_nmf",
    "separate_signal",
    "DemixEstimate",
    "demix",
    "HMMSpectra",
    "fit_hmm_spectra",
    "fit_multichannel_hmm",
    "sticky_transition",
    "LeadSeparation",
    "harmonic_dictionary",
    "hann_filter_basis",
    "separate_lead",
    "StereoSIMM",
    "StereoLeadSeparation",
    "stereo_simm",
    "separate_lead_stereo",
    "MultichannelSF",
    "MultichannelLead",
    "fit_multichannel_sf",
    "separate_lead_multichannel",
    "ula_steering",
    "mvdr_filter",
    "directivity_diagram",
    "apply_beamformer",
]

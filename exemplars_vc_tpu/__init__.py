"""exemplars_vc_tpu — an accelerator-native exemplar-based voice-conversion framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
research pipeline ``entn-at/exemplars_vc`` (see SURVEY.md):

- ``config``     typed configuration (replaces the flat INI dict, reference
                 ``utils.py:52-92`` / ``config/config``)
- ``io``         wav + artifact IO, speaker stores, native C++ loader
                 (replaces ``utils.py:95-220``)
- ``dsp``        framing/windows, STFT/ISTFT, mel/MFCC, Griffin-Lim, mel-cepstrum,
                 LPC/LSP — jitted JAX (replaces librosa/pysptk usage in
                 ``01_make_dict_parallel.py:86-139``, ``zz_audio_utilities.py``)
- ``world``      WORLD-class vocoder analysis/synthesis in JAX (replaces pyworld
                 usage in ``03_a_b_r_parallel.py:85-98``, ``04_align_n_nmf.py:396-431``)
- ``align``      batched wavefront DTW + exemplar dictionary construction
                 (replaces the ``dtw`` package, ``01_make_dict_parallel.py:215-249``)
- ``factorize``  fixed-dictionary NMF multiplicative updates, residual
                 compensation, conversion, QR variant (replaces sklearn NMF in
                 ``04_align_n_nmf.py:194-333``)
- ``models``     scan-based LSTM warping net + training loop (replaces
                 ``models.py`` / ``02_freq_warping_neural.py``)
- ``separate``   source separation — the vendored pyfasst capability set:
                 IS-NMF tools, source/filter NMF, FASST-class multichannel
                 NMF EM with Wiener filtering (``dependencies/pyfasst-master``)
- ``parallel``   device meshes, sharded NMF/DTW, batched separation,
                 multi-host init (new; the reference only has
                 multiprocessing.Pool)
- ``pipelines``  the end-to-end stages 01..05 as library functions + CLI
- ``obs``        logging, metrics (MCD), profiling hooks
"""

__version__ = "0.1.0"

from exemplars_vc_tpu.config import Config, load_config  # noqa: F401

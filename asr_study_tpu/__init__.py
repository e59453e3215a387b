"""asr_study_tpu — a JAX/XLA end-to-end speech recognition framework with
the capabilities of the reference ``igormq/asr-study`` (Keras/TF1), run on
an NVIDIA GPU (tested on the CPU).

Pipeline (mirrors the reference's, cf. SURVEY.md §0):

    raw 16 kHz WAV
      -> framing -> STFT -> mel filterbank -> log-fbank / MFCC (+deltas)   features/
      -> feature dataset (packed .npy directory or vlen HDF5)             data/
      -> duration-sorted, length-bucketed padded batches                   data/
      -> stacked BLSTM / GRU acoustic model (+ layer-norm / zoneout /
         multiplicative-integration / highway-residual LSTM variants)      models/
      -> CTC loss (log-space forward-backward, lax.scan)                   ops/ctc.py
      -> greedy / prefix-beam-search CTC decoding                          ops/ctc.py, ops/beam.py
      -> CER / WER evaluation                                              ops/metrics.py, train/

All device compute is JAX (jit / shard_map over a jax.sharding.Mesh);
host-side data plumbing is NumPy with an optional C++ fast path.
"""

__version__ = "0.1.0"

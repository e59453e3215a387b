"""On-device ops: CTC loss, decoders, metrics.

Replaces the reference's delegation to TF's C++ CTC / edit-distance ops
[ref: core/ctc_utils.py, core/metrics.py] with on-device JAX implementations
(log-semiring scans, fully jittable / vmappable / differentiable).
"""

from asr_study_tpu.ops.ctc import blank_collapse, ctc_loss, greedy_decode
from asr_study_tpu.ops.beam import beam_search_decode
from asr_study_tpu.ops.metrics import edit_distance, ler, wer

__all__ = [
    "blank_collapse",
    "ctc_loss",
    "greedy_decode",
    "beam_search_decode",
    "edit_distance",
    "ler",
    "wer",
]

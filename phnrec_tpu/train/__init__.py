"""HMM training / re-estimation on the accelerator.

The bundled STK toolkit carries complete training machinery that phnrec
itself never calls: exact forward-backward (Network::ForwardBackward,
STKLib/Viterbi.cc:2115+), Baum-Welch / Viterbi / MCE re-estimation
(BaumWelchReest / ViterbiReest / MCEReest, STKLib/Viterbi.h:253-259,
Viterbi.cc:1124-1240), per-mixture/transition accumulators and the
ML / MMI extended-Baum-Welch parameter updates (ModelSet::UpdateFromAccums,
STKLib/Models.h:473,541; update types AT_ML/AT_MPE/AT_MMI/AT_MCE,
Viterbi.h:63-70).

This package is the tensor-program equivalent: an utterance's transcription is
compiled into a dense linear composite HMM (train.graph), forward-backward
and Viterbi alignment run as batched `lax.scan`s over frames with the
transition pass expressed as [S, S] log-matmuls (train.fb),
statistics land in fixed-shape accumulator pytrees that `psum` across a
data mesh (train.accum), and parameter updates are pure functions over
those accumulators (train.update: ML, extended-Baum-Welch MMI, MCE
utterance weighting).
"""

from phnrec_tpu.train.graph import TrainGraph, compile_transcription
from phnrec_tpu.train.fb import forward_backward, viterbi_align
from phnrec_tpu.train.accum import Accumulators, make_accumulators, \
    accumulate_utterance, merge_accumulators, psum_accumulators, \
    save_accumulators, load_accumulators
from phnrec_tpu.train.mbr import accumulate_utterance_mbr, reference_hmm_ids
from phnrec_tpu.train.update import update_ml, update_mmi, mce_weight, \
    apply_update

__all__ = [
    "TrainGraph", "compile_transcription",
    "forward_backward", "viterbi_align",
    "Accumulators", "make_accumulators", "accumulate_utterance",
    "merge_accumulators", "psum_accumulators",
    "save_accumulators", "load_accumulators",
    "accumulate_utterance_mbr", "reference_hmm_ids",
    "update_ml", "update_mmi", "mce_weight", "apply_update",
]

"""Default training hyperparameters (copy of
yogo_tpu/utils/default_hyperparams.py).

The values are a compatibility surface - they must equal the reference's
defaults (reference: yogo/utils/default_hyperparams.py:1-12) so that runs
launched with no flags behave identically. The anchor is the k-means fit to
the remoscope blood-cell dataset's boxes (see utils/cluster_anchors.py for
refitting on new data).
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class _Defaults:
    # optimization recipe
    EPOCHS: int = 64
    BATCH_SIZE: int = 64
    LEARNING_RATE: float = 3e-4
    DECAY_FACTOR: float = 10  # cosine decays lr to LEARNING_RATE / this
    WEIGHT_DECAY: float = 5e-2
    LABEL_SMOOTHING: float = 0.01

    # loss term weights
    IOU_WEIGHT: float = 5.0
    NO_OBJ_WEIGHT: float = 0.5
    CLASSIFY_WEIGHT: float = 1.0

    # single anchor (w, h), normalized image coordinates
    ANCHOR_W: float = 0.04250100424705710
    ANCHOR_H: float = 0.05551774140353888

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


DefaultHyperparams = _Defaults()

from .composites import hurdle_combine, hurdle_on_indices, zero_inflated_combine
from .kron import (
    ClassPrediction,
    HurdlePrediction,
    KronGP,
    KronHurdleSVGP,
    KronOnOffSVGP,
    KronSVGP,
    LatentPrediction,
)
from .onoff import OnOffPrediction, gated_y_from, gated_y_samples

__all__ = [
    "ClassPrediction",
    "HurdlePrediction",
    "KronGP",
    "KronHurdleSVGP",
    "KronOnOffSVGP",
    "KronSVGP",
    "LatentPrediction",
    "OnOffPrediction",
    "gated_y_from",
    "gated_y_samples",
    "hurdle_combine",
    "hurdle_on_indices",
    "zero_inflated_combine",
]

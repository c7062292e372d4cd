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
from .onoff import OnOffPrediction

__all__ = [
    "ClassPrediction",
    "HurdlePrediction",
    "KronGP",
    "KronHurdleSVGP",
    "KronOnOffSVGP",
    "KronSVGP",
    "LatentPrediction",
    "OnOffPrediction",
    "hurdle_combine",
    "hurdle_on_indices",
    "zero_inflated_combine",
]

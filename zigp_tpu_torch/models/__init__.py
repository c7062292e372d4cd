from .composites import hurdle_combine, hurdle_on_indices, zero_inflated_combine
from .kron import (
    ClassPrediction,
    HurdlePrediction,
    KronGP,
    KronHurdleSVGP,
    KronOnOffSVGP,
    KronSVGP,
    LatentPrediction,
    gen_input_masks,
)
from .onoff import OnOffPrediction, OnOffSVGP, gated_y_from, gated_y_samples
from .svgp import SVGP

__all__ = [
    "ClassPrediction",
    "HurdlePrediction",
    "KronGP",
    "KronHurdleSVGP",
    "KronOnOffSVGP",
    "KronSVGP",
    "LatentPrediction",
    "OnOffPrediction",
    "OnOffSVGP",
    "SVGP",
    "gated_y_from",
    "gated_y_samples",
    "gen_input_masks",
    "hurdle_combine",
    "hurdle_on_indices",
    "zero_inflated_combine",
]

from .kron import KronGP, KronOnOffSVGP
from .onoff import OnOffPrediction

__all__ = ["KronGP", "KronOnOffSVGP", "OnOffPrediction"]

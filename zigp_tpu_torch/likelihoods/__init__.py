from .likelihoods import Bernoulli, Gamma, Gaussian, LogNormal, OnOffGaussian

__all__ = ["Bernoulli", "Gamma", "Gaussian", "LogNormal", "OnOffGaussian"]

from .likelihoods import Gaussian, OnOffGaussian

__all__ = ["Gaussian", "OnOffGaussian"]

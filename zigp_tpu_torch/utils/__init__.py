from . import logging, metrics, plotting
from .logging import MetricLogger

__all__ = ["metrics", "plotting", "logging", "MetricLogger"]

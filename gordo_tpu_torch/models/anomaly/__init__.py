"""Anomaly detectors around the port's estimators."""

from .diff import DiffBasedAnomalyDetector

__all__ = ["DiffBasedAnomalyDetector"]

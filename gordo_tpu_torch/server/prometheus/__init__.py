"""The server's Prometheus metrics (``metrics.py``)."""

"""
The server's request metrics (the port of
``gordo_tpu.server.prometheus.metrics``): the request-duration histogram
and the request counter, labelled (method, path, status_code,
gordo_name, gordo_project), and the ``gordo_server`` info metric, with
the JAX server's names, labels, help texts and ``prometheus_client``'s
default buckets. :meth:`GordoServerPrometheusMetrics.exposition` writes
them, then the process registry's series, in the Prometheus text format
(``observability/prom_text.py``), as the JAX server's ``/metrics``
writes its collector registry and the registry bridged into it.
"""

import threading
import time
from typing import Dict, Tuple

from gordo_tpu_torch import __version__
from gordo_tpu_torch.observability import prom_text
from gordo_tpu_torch.observability.registry import MetricsRegistry, get_registry

#: ``prometheus_client.Histogram.DEFAULT_BUCKETS``
REQUEST_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0,
                   7.5, 10.0)


class GordoServerPrometheusMetrics:
    """Observes every request the server answers, probes and scrapes
    aside, labelled as the JAX server of no one project labels them."""

    def __init__(self):
        self.info = {"version": __version__}
        labels = ["method", "path", "status_code", "gordo_name", "gordo_project"]
        self._own = MetricsRegistry()
        self.request_duration_seconds = self._own.histogram(
            "gordo_server_request_duration_seconds", "HTTP request duration, in seconds",
            labels, buckets=REQUEST_BUCKETS,
        )
        self.requests_total = self._own.counter(
            "gordo_server_requests_total", "Total HTTP requests", labels
        )
        # a series' creation time, written as prometheus_client writes it
        self._created: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {
            "gordo_server_request_duration_seconds": {},
            "gordo_server_requests_total": {},
        }
        self._lock = threading.Lock()

    def observe(self, method: str, path: str, endpoint: str, status: int,
                duration: float) -> None:
        """One answered request: ``endpoint`` is its view's name
        (``unmatched`` when no route matched); the project and model
        labels are read from the path as the JAX server reads them
        (``/gordo/v0/<project>/<third segment, when there are five>``)."""
        parts = path.strip("/").split("/")
        model = project = ""
        if len(parts) >= 3 and parts[0] == "gordo":
            project = parts[2]
            if len(parts) >= 5:
                model = parts[3]
        labels = {"method": method, "path": endpoint, "status_code": str(status),
                  "gordo_name": model, "gordo_project": project}
        key = tuple(sorted(labels.items()))
        with self._lock:
            now = time.time()
            for created in self._created.values():
                created.setdefault(key, now)
        self.request_duration_seconds.observe(duration, **labels)
        self.requests_total.inc(**labels)

    def exposition(self) -> bytes:
        """The scrape: the info metric, the request metrics, then every
        metric of the process registry."""
        own = self._own.snapshot()
        with self._lock:
            created = {name: dict(series) for name, series in self._created.items()}
        parts = [prom_text.info_text("gordo_server", "Gordo TPU server info", self.info)]
        for name in ("gordo_server_request_duration_seconds", "gordo_server_requests_total"):
            parts.append(prom_text.family_text(name, own[name], created=created[name]))
        parts.append(prom_text.registry_text(get_registry().snapshot()))
        return "".join(parts).encode()

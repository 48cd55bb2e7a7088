"""
The model server (the port of ``gordo_tpu.server.app``'s single-machine
routes), a plain WSGI callable on the standard library and JSON:

- ``GET  /healthcheck``
- ``GET  /gordo/v0/<project>/models``
- ``GET  /gordo/v0/<project>/revisions``
- ``GET  /gordo/v0/<project>/expected-models``
- ``GET  /gordo/v0/<project>/<name>/metadata`` (also ``…/healthcheck``)
- ``GET  /gordo/v0/<project>/<name>/download-model``
- ``POST /gordo/v0/<project>/<name>/prediction``
- ``POST /gordo/v0/<project>/<name>/anomaly/prediction``

Request and response bodies, status codes and error bodies are those of
the JAX server; every JSON body and response carries the ``revision``
served. The served revision is the collection directory's name, or the
sibling directory that a ``?revision=`` query or a ``revision`` header
names (:func:`resolve_sibling_revision`; a name it refuses gets 410).
Models load on first use onto the app's device and stay there, keyed by
their real directory.
"""

import json
import logging
import os
import re
import threading
import timeit
import traceback
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple
from urllib.parse import parse_qs

from gordo_tpu_torch import __version__, serializer
from gordo_tpu_torch.data.sensor_tag import tag_names
from gordo_tpu_torch.device import DeviceLike, resolve_device
from gordo_tpu_torch.models.utils import make_base_dataframe
from gordo_tpu_torch.server import utils as server_utils
from gordo_tpu_torch.server.utils import ApiError

logger = logging.getLogger(__name__)

MODEL_COLLECTION_DIR_ENV_VAR = "MODEL_COLLECTION_DIR"
EXPECTED_MODELS_ENV_VAR = "EXPECTED_MODELS"

_STATUS_TEXT = {
    200: "OK",
    400: "BAD REQUEST",
    404: "NOT FOUND",
    405: "METHOD NOT ALLOWED",
    410: "GONE",
    422: "UNPROCESSABLE ENTITY",
    500: "INTERNAL SERVER ERROR",
}

_PROJECT = r"/gordo/v0/(?P<gordo_project>[^/]+)"
_MACHINE = _PROJECT + r"/(?P<gordo_name>[^/]+)"
#: (method, path pattern, view name)
_ROUTES = [
    ("GET", r"/healthcheck", "healthcheck"),
    ("GET", _PROJECT + r"/models", "models"),
    ("GET", _PROJECT + r"/revisions", "revisions"),
    ("GET", _PROJECT + r"/expected-models", "expected_models"),
    ("GET", _MACHINE + r"/metadata", "metadata"),
    ("GET", _MACHINE + r"/healthcheck", "metadata"),
    ("GET", _MACHINE + r"/download-model", "download_model"),
    ("POST", _MACHINE + r"/prediction", "prediction"),
    ("POST", _MACHINE + r"/anomaly/prediction", "anomaly_prediction"),
]
_COMPILED_ROUTES = [(m, re.compile(p + r"/?$"), v) for m, p, v in _ROUTES]


class Response:
    """One reply: a status and either body bytes or a JSON payload, which
    is encoded once the revision is stamped into it."""

    def __init__(
        self,
        body: bytes = b"",
        status: int = 200,
        mimetype: str = "text/plain",
        payload: Optional[dict] = None,
    ):
        self.body = body
        self.status = status
        self.mimetype = mimetype
        self.payload = payload
        self.headers: Dict[str, str] = {}


def _json_response(payload: dict, status: int = 200) -> Response:
    return Response(status=status, mimetype="application/json", payload=payload)


def resolve_sibling_revision(latest_dir: str, requested: str) -> Optional[str]:
    """
    The path of revision ``requested`` as a sibling of ``latest_dir``, or
    None when the name is not servable (the JAX server's name policy):
    dot names (staging directories and lifecycle state), names with a
    path separator (they would traverse), a symlink sibling (an alias of
    a revision, such as ``latest``), a loose file and a missing name.
    """
    if requested.startswith(".") or "/" in requested or "\\" in requested:
        return None
    candidate = os.path.join(latest_dir, "..", requested)
    if os.path.islink(candidate):
        return None
    try:
        os.listdir(candidate)
    except (FileNotFoundError, NotADirectoryError):
        return None
    return candidate


class Revision(NamedTuple):
    """What one request serves: the revision's name and directory (None
    for a name that cannot be served)."""

    name: str
    directory: Optional[str]


class GordoApp:
    """WSGI application serving one collection of port artifacts."""

    def __init__(
        self, collection_dir: Optional[str] = None, device: DeviceLike = None
    ):
        self.device = resolve_device(device)
        self.collection_dir = collection_dir or os.environ[MODEL_COLLECTION_DIR_ENV_VAR]
        self.revision = os.path.basename(os.path.normpath(self.collection_dir))
        # keyed by (real directory of the revision, model name)
        self._models: Dict[Tuple[str, str], Any] = {}
        self._metadata: Dict[Tuple[str, str], dict] = {}
        self._lock = threading.Lock()

    # -- WSGI plumbing -----------------------------------------------------
    def __call__(self, environ, start_response):
        response = self.dispatch(
            environ.get("REQUEST_METHOD", "GET"),
            environ.get("PATH_INFO", "/") or "/",
            lambda: _read_body(environ),
            query_string=environ.get("QUERY_STRING", ""),
            revision=environ.get("HTTP_REVISION"),
        )
        headers = [
            ("Content-Type", response.mimetype),
            ("Content-Length", str(len(response.body))),
            *response.headers.items(),
        ]
        status = f"{response.status} {_STATUS_TEXT.get(response.status, '')}".strip()
        start_response(status, headers)
        return [response.body]

    def dispatch(
        self,
        method: str,
        path: str,
        read_body: Callable[[], bytes],
        query_string: str = "",
        revision: Optional[str] = None,
    ) -> Response:
        """One request: ``revision`` is the ``revision`` header's value; a
        ``revision`` in ``query_string`` takes precedence over it."""
        view, url_args = self._match(method, path)
        served = Revision(self.revision, self.collection_dir)
        try:
            if view is None:
                response = url_args  # the 404/405 reply
            else:
                requested = parse_qs(query_string).get("revision", [None])[0] or revision
                if requested:
                    directory = resolve_sibling_revision(self.collection_dir, requested)
                    served = Revision(requested, directory)
                if served.directory is None:
                    response = _json_response(
                        {"error": f"Revision '{requested}' not found."}, 410
                    )
                else:
                    response = getattr(self, f"view_{view}")(served, read_body, **url_args)
        except ApiError as exc:
            response = _json_response(exc.payload, exc.status)
        except Exception:
            logger.error("Unhandled server error:\n%s", traceback.format_exc())
            response = _json_response(
                {"error": "Something unexpected happened; check your input data"}, 500
            )
        if served.directory is not None:  # a 410 names no revision
            if response.payload is not None:
                response.payload["revision"] = served.name
            response.headers["revision"] = served.name
        if response.payload is not None:
            response.body = json.dumps(response.payload, default=str).encode()
        return response

    @staticmethod
    def _match(method: str, path: str) -> Tuple[Optional[str], Any]:
        allowed = False
        for route_method, pattern, view in _COMPILED_ROUTES:
            match = pattern.match(path)
            if match:
                if route_method == method:
                    return view, match.groupdict()
                allowed = True
        if allowed:
            return None, _json_response({"error": f"Method {method} not allowed"}, 405)
        return None, _json_response({"error": f"No route for {path}"}, 404)

    # -- model/metadata loading --------------------------------------------
    @staticmethod
    def _artifact_dir(served: Revision, name: str) -> str:
        if name.startswith(".") or os.sep in name:
            raise ApiError({"error": f"Model '{name}' not found"}, 404)
        return os.path.join(served.directory, name)

    @staticmethod
    def _model_missing(served: Revision, name: str) -> ApiError:
        return ApiError({"error": f"Model '{name}' not found in revision {served.name}"}, 404)

    def _get_model(self, served: Revision, name: str):
        key = (os.path.realpath(served.directory), name)
        with self._lock:
            model = self._models.get(key)
            if model is None:
                try:
                    model = serializer.load(self._artifact_dir(served, name), self.device)
                except FileNotFoundError:
                    raise self._model_missing(served, name) from None
                self._models[key] = model
        return model

    def _get_metadata(self, served: Revision, name: str) -> dict:
        key = (os.path.realpath(served.directory), name)
        with self._lock:
            metadata = self._metadata.get(key)
            if metadata is None:
                try:
                    metadata = serializer.load_metadata(self._artifact_dir(served, name))
                except FileNotFoundError:
                    raise ApiError(
                        {"error": f"Metadata for '{name}' not found"}, 404
                    ) from None
                self._metadata[key] = metadata
        return metadata

    @staticmethod
    def _tags(metadata: dict) -> Tuple[List[str], List[str]]:
        dataset = metadata["dataset"]
        tags = tag_names(dataset["tag_list"])
        targets = tag_names(dataset.get("target_tag_list") or [])
        return tags, targets or tags

    def _extract(self, read_body, metadata: dict):
        tags, target_tags = self._tags(metadata)
        try:
            body = json.loads(read_body() or b"null")
        except ValueError:
            body = None
        X, y = server_utils.extract_X_y(body, tags, target_tags)
        return tags, target_tags, X, y

    # -- views -------------------------------------------------------------
    def view_healthcheck(self, served: Revision, read_body) -> Response:
        return Response(b"", 200)

    def view_models(self, served: Revision, read_body, gordo_project: str) -> Response:
        try:
            names = sorted(
                name
                for name in os.listdir(served.directory)
                if not name.startswith(".")
                and os.path.isdir(os.path.join(served.directory, name))
            )
        except FileNotFoundError:
            names = []
        return _json_response({"models": names})

    def view_revisions(self, served: Revision, read_body, gordo_project: str) -> Response:
        """The sibling real directories of the served revision: no dot
        entries, no symlinks, no files. ``latest`` is the app's own."""
        parent = os.path.join(served.directory, "..")
        try:
            available = sorted(
                name
                for name in os.listdir(parent)
                if not name.startswith(".")
                and os.path.isdir(os.path.join(parent, name))
                and not os.path.islink(os.path.join(parent, name))
            )
        except FileNotFoundError:
            available = [self.revision]
        return _json_response({"latest": self.revision, "available-revisions": available})

    def view_expected_models(self, served: Revision, read_body, gordo_project: str) -> Response:
        """``$EXPECTED_MODELS`` as a JSON list; ``[]`` when it is unset."""
        return _json_response(
            {"expected-models": json.loads(os.environ.get(EXPECTED_MODELS_ENV_VAR, "[]"))}
        )

    def view_metadata(
        self, served: Revision, read_body, gordo_project: str, gordo_name: str
    ) -> Response:
        return _json_response(
            {
                "gordo-server-version": __version__,
                "metadata": self._get_metadata(served, gordo_name),
                "env": {MODEL_COLLECTION_DIR_ENV_VAR: self.collection_dir},
            }
        )

    def view_download_model(
        self, served: Revision, read_body, gordo_project: str, gordo_name: str
    ) -> Response:
        """The model's artifact as one gzipped tar of its three files
        (``serializer.dumps``; ``serializer.loads`` reads it back). The
        JAX route sends a pickle; the port's artifacts are never pickled."""
        try:
            body = serializer.dumps(self._artifact_dir(served, gordo_name))
        except FileNotFoundError:
            raise self._model_missing(served, gordo_name) from None
        response = Response(body, 200, mimetype="application/octet-stream")
        response.headers["Content-Disposition"] = "attachment; filename=model.tar.gz"
        return response

    def view_prediction(
        self, served: Revision, read_body, gordo_project: str, gordo_name: str
    ) -> Response:
        start = timeit.default_timer()
        model = self._get_model(served, gordo_name)
        tags, target_tags, X, _ = self._extract(
            read_body, self._get_metadata(served, gordo_name)
        )
        try:
            output = model.predict(X)
        except ValueError as err:
            return _json_response({"error": f"ValueError: {err}"}, 400)
        except Exception:
            logger.error("Failed to predict:\n%s", traceback.format_exc())
            return _json_response(
                {"error": "Something unexpected happened; check your input data"}, 400
            )
        data = make_base_dataframe(
            tags=tags,
            model_input=X.values,
            model_output=output,
            target_tag_list=target_tags,
            index=X.index,
        )
        return _json_response(
            {
                "data": server_utils.dataframe_to_dict(data),
                "time-seconds": f"{timeit.default_timer() - start:.4f}",
            }
        )

    def view_anomaly_prediction(
        self, served: Revision, read_body, gordo_project: str, gordo_name: str
    ) -> Response:
        start = timeit.default_timer()
        model = self._get_model(served, gordo_name)
        metadata = self._get_metadata(served, gordo_name)
        _, _, X, y = self._extract(read_body, metadata)
        if y is None:
            return _json_response(
                {"message": "Cannot perform anomaly without 'y' to compare against."},
                400,
            )
        frequency = server_utils.resolution_to_timedelta(
            metadata["dataset"].get("resolution", "10min")
        )
        try:
            anomaly = model.anomaly(X, y, frequency=frequency)
        except AttributeError:
            return _json_response(
                {
                    "message": "Model is not an AnomalyDetector, it is of type: "
                    f"{type(model)}"
                },
                422,
            )
        except ValueError as err:
            return _json_response({"error": f"ValueError: {err}"}, 400)
        return _json_response(
            {
                "data": server_utils.dataframe_to_dict(anomaly),
                "time-seconds": f"{timeit.default_timer() - start:.4f}",
            }
        )


def _read_body(environ) -> bytes:
    try:
        length = int(environ.get("CONTENT_LENGTH") or 0)
    except ValueError:
        length = 0
    return environ["wsgi.input"].read(length) if length > 0 else b""


def build_app(collection_dir: Optional[str] = None, device: DeviceLike = None) -> GordoApp:
    """The WSGI app over ``collection_dir`` (default: ``$MODEL_COLLECTION_DIR``)
    on ``device`` (the card unless ``"cpu"`` is asked for)."""
    return GordoApp(collection_dir, device)

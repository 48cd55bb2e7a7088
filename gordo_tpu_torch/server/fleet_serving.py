"""
Fleet serving: stacked-weight batched scoring (the port of
``gordo_tpu.server.fleet_serving``).

Trained estimators of one architecture are grouped, and each group's
weights are stacked on a leading machine axis once, on the device the
models were loaded onto, where they stay: one ``(M, ...)`` tensor per
state-dict entry, in bfloat16 for a group of bf16 machines. A request
scores every machine of a group with one forward, ``torch.func.vmap`` of
``torch.func.functional_call`` of the solo module (as
``FleetTrainer.predict`` does), so the flash kernels run once a layer
for the whole group: their ``vmap`` rule folds the machine axis into the
kernels' batch.

The shape policy is the JAX scorer's: rows padded to the next power of
two; the full group (or a subset whose machine bucket rounds up to it)
scattered into the resident stack; other subsets, and requests that name
a machine twice (coalesced requests), through a gathered copy of those
machines' weights on a machine axis of a power of two, at least 2 (a
single machine's repeated copy is kept, at most ``REPEAT_CACHE_SIZE`` of
them); at most ``max(MIN_DISPATCH_ENTRIES, group size)`` entries a
forward. Windowed models get raw rows and gather their windows on the
device. Host prefix transformers (scalers) run per machine before this,
in the server.

A stream's update (``streaming/window.py``) is an entry like a one-shot
request's array: its context stays on the device and only its new rows
are copied, so a batch holding one is assembled on the device.

Left out, because the TPU-era scorer does them for XLA: AOT executables
and their program store and buffer donation (ROADMAP.md queue 1 item 9),
and the metrics registry.
"""

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call, vmap

from gordo_tpu_torch.models.core import BaseTorchEstimator, first_output
from gordo_tpu_torch.models.specs import cast
from gordo_tpu_torch.parallel.precision import cast_params

#: floor on the entries of one forward when requests are coalesced; a
#: group larger than this takes its own size
MIN_DISPATCH_ENTRIES = 64
#: the repeated single-machine weight copies a group keeps
REPEAT_CACHE_SIZE = 128

Tensors = Dict[str, torch.Tensor]


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n."""
    bucket = 1
    while bucket < n:
        bucket *= 2
    return bucket


def _plain(value) -> Any:
    """A module attribute as a comparable value: numbers, strings and
    flags as they are, functions by name, anything else by repr."""
    if isinstance(value, (bool, int, float, str, type(None))):
        return value
    if callable(value) and hasattr(value, "__name__"):
        return value.__name__
    return repr(value)


def module_signature(module: nn.Module) -> Tuple:
    """The net's definition as a hashable value: every submodule's class
    and plain attributes (widths, flags, activations, compute type), and
    every state-dict entry's shape and type. Two estimators with one
    signature run the same forward on their own weights."""
    parts = []
    for name, sub in module.named_modules():
        attrs = tuple(
            (key, _plain(value))
            for key, value in sorted(vars(sub).items())
            if not key.startswith("_") and key != "training"
        )
        parts.append((name, type(sub).__name__, attrs))
    state = tuple(
        (name, tuple(value.shape), str(value.dtype)) for name, value in module.state_dict().items()
    )
    return tuple(parts), state


def group_key(est: BaseTorchEstimator) -> Tuple:
    """Machines whose estimators share this key are stacked and scored
    together: net definition and widths, window geometry, and the
    serving precision when it is not float32 (JAX ``_group_key``)."""
    spec = est.spec_
    key = (
        module_signature(spec.module),
        spec.windowed,
        spec.lookback_window if spec.windowed else 1,
        est.lookahead if spec.windowed else 0,
        est.n_features_,
        est.n_features_out_,
    )
    precision = getattr(est, "precision_", "float32")
    if precision != "float32":
        key = key + (f"precision={precision}",)
    return key


class FleetScorer:
    """
    Batched scorer over fitted port estimators, grouped by
    :func:`group_key`; each group's weights stacked on a machine axis on
    the estimators' device (see the module note).
    """

    def __init__(self, estimators: Dict[str, BaseTorchEstimator]):
        for name, est in estimators.items():
            if not hasattr(est, "spec_"):
                raise ValueError(f"Estimator for {name!r} is not fitted")
        by_key: Dict[Tuple, List[str]] = {}
        for name, est in estimators.items():
            by_key.setdefault(group_key(est), []).append(name)
        self._groups: List[dict] = []
        for names in by_key.values():
            ests = [estimators[n] for n in names]
            first = ests[0]
            spec, device = first.spec_, first.device_
            stacked = {
                key: torch.stack([e.spec_.module.state_dict()[key] for e in ests]).to(device)
                for key in spec.module.state_dict()
            }
            precision = getattr(first, "precision_", "float32")
            if precision == "bf16":
                stacked = cast_params(stacked, torch.bfloat16)
            # a module of its own, whose weights functional_call replaces:
            # the machines' own modules keep serving their solo routes
            proto = first._build_spec().module.to(device).eval()
            self._groups.append({
                "names": names,
                "params": stacked,
                "module": proto,
                "lock": threading.Lock(),
                "device": device,
                "precision": precision,
                "windowed": spec.windowed,
                "lookback": spec.lookback_window if spec.windowed else 1,
                "lookahead": first.lookahead if spec.windowed else 0,
                "n_features": first.n_features_,
                "n_features_out": first.n_features_out_,
                # real widths of padded-bucket machines: inputs are widened
                # to the group's width and outputs cut back
                "in_cols": {n: getattr(e, "n_active_features_", None) or e.n_features_
                            for n, e in zip(names, ests)},
                "out_cols": {n: getattr(e, "n_active_features_out_", None) or e.n_features_out_
                             for n, e in zip(names, ests)},
                "repeats": {},
                # forwards by weight source: the resident stack or a gathered copy
                "dispatches": {"resident": 0, "gathered": 0},
            })

    @property
    def names(self) -> List[str]:
        return [n for g in self._groups for n in g["names"]]

    @property
    def n_groups(self) -> int:
        return len(self._groups)

    def dispatch_counts(self) -> Dict[str, int]:
        """Forwards so far that scattered into a resident stack and that
        ran on a gathered copy, over every group."""
        return {
            source: sum(g["dispatches"][source] for g in self._groups)
            for source in ("resident", "gathered")
        }

    def group_precisions(self) -> Dict[str, str]:
        """Each machine's serving precision (its group's)."""
        return {n: g["precision"] for g in self._groups for n in g["names"]}

    def machine_geometry(self, name: str) -> Dict[str, Any]:
        """One machine's window geometry and real widths."""
        for group in self._groups:
            if name in group["names"]:
                return {
                    "windowed": group["windowed"],
                    "lookback": group["lookback"],
                    "lookahead": group["lookahead"],
                    "n_features": group["in_cols"][name],
                    "n_features_out": group["out_cols"][name],
                }
        raise KeyError(f"No stacked params for machine {name!r}")

    def predict(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """
        Model outputs for each named machine: ``inputs[name]`` is its
        model input (prefix transformers applied), (rows, n_features),
        rows free per machine. One request through
        :meth:`predict_requests`, so solo and coalesced requests take one
        code path.
        """
        return self.predict_requests([inputs])[0]

    def predict_requests(
        self, requests: Sequence[Dict[str, np.ndarray]]
    ) -> List[Dict[str, np.ndarray]]:
        """
        Coalesced scoring: every request's (machine, X) entries on one
        machine axis, one forward a group (and chunk); a machine named by
        k requests takes k rows. One ``{name: output}`` a request, in
        request order. ``KeyError`` for a machine the scorer lacks.
        """
        known = set(self.names)
        for inputs in requests:
            missing = set(inputs) - known
            if missing:
                raise KeyError(f"No stacked params for machines: {sorted(missing)}")
        out: List[Dict[str, np.ndarray]] = [{} for _ in requests]
        for group in self._groups:
            entries = [
                (ridx, name, inputs[name])
                for ridx, inputs in enumerate(requests)
                for name in group["names"]
                if name in inputs
            ]
            chunk = max(MIN_DISPATCH_ENTRIES, len(group["names"]))
            for start in range(0, len(entries), chunk):
                sub = entries[start : start + chunk]
                for (ridx, name, _), value in zip(sub, self._predict_entries(group, sub)):
                    out[ridx][name] = value
        return out

    def _prepare(self, group: dict, entries):
        """(names, (entries, padded rows, group width) float32 batch,
        output rows of each entry, whether the batch is on the device).
        An entry is a host array (a one-shot request) or a
        :class:`~gordo_tpu_torch.streaming.window.WindowUpdate` (a stream:
        its resident context and new rows, already on the device). With
        no stream entry the batch is assembled on the host and copied
        once; with one it is assembled on the device, each host entry
        copied there (padding and stacking move bytes, so the batch holds
        the same values either way)."""
        from gordo_tpu_torch.streaming.window import WindowUpdate

        names = [name for _, name, _ in entries]
        lb, la, width = group["lookback"], group["lookahead"], group["n_features"]
        on_device = any(isinstance(X, WindowUpdate) for _, _, X in entries)
        prepared = []
        for name, (_, _, X) in zip(names, entries):
            # the machine's real width: zero columns stand only for the
            # pad a padded bucket trained with
            n_real = group["in_cols"][name]
            if isinstance(X, WindowUpdate):
                if X.width != n_real:
                    raise ValueError(
                        f"Machine {name!r} expects {n_real} feature column(s), got {X.width}"
                    )
                x = X.materialize()  # the update's only host-to-device copy
            else:
                x = np.asarray(X, dtype=np.float32)
                if x.ndim != 2 or x.shape[-1] != n_real:
                    raise ValueError(
                        f"Machine {name!r} expects {n_real} feature column(s), got "
                        f"{x.shape[-1] if x.ndim else 0}"
                    )
                if on_device:
                    x = torch.from_numpy(np.ascontiguousarray(x)).to(group["device"])
            if n_real < width:
                x = (F.pad(x, (0, width - n_real)) if on_device
                     else np.pad(x, [(0, 0), (0, width - n_real)]))
            prepared.append(x)
        if group["windowed"]:
            for name, x in zip(names, prepared):
                if len(x) - lb + 1 - la <= 0:
                    raise ValueError(
                        f"Not enough timesteps ({len(x)}) for machine {name!r}: "
                        f"lookback_window={lb}, lookahead={la}"
                    )
            n_rows = [len(x) - lb + 1 - la for x in prepared]
        else:
            n_rows = [len(x) for x in prepared]
        max_rows = pow2_bucket(max(len(x) for x in prepared))
        if on_device:
            batch = torch.stack([F.pad(x, (0, 0, 0, max_rows - len(x))) for x in prepared])
        else:
            batch = np.stack([np.pad(x, [(0, max_rows - len(x)), (0, 0)]) for x in prepared])
        return names, batch, n_rows, on_device

    def _select(self, group: dict, names: List[str]) -> Tuple[Tensors, List[int], int]:
        """(weights, the machine-axis row of each entry, machine bucket):
        the resident stack for the full group or a subset that rounds up
        to it, else a gathered copy (a single machine's kept)."""
        group_size = len(group["names"])
        if len(set(names)) == len(names) and group_size >= 2:
            m_bucket = min(max(2, pow2_bucket(len(names))), group_size)
            if names == group["names"] or m_bucket == group_size:
                group["dispatches"]["resident"] += 1
                position = {n: i for i, n in enumerate(group["names"])}
                return group["params"], [position[n] for n in names], group_size
        else:
            m_bucket = max(2, pow2_bucket(len(names)))
        group["dispatches"]["gathered"] += 1
        sel = [group["names"].index(n) for n in names]
        sel += [sel[0]] * (m_bucket - len(sel))
        if len(set(sel)) == 1:
            repeats = group["repeats"]
            key = (sel[0], m_bucket)
            params = repeats.get(key)
            if params is None:
                while len(repeats) >= REPEAT_CACHE_SIZE:
                    repeats.pop(next(iter(repeats)))
                params = self._gather(group, sel)
                repeats[key] = params
        else:
            params = self._gather(group, sel)
        return params, list(range(len(names))), m_bucket

    @staticmethod
    def _gather(group: dict, sel: List[int]) -> Tensors:
        index = torch.tensor(sel, device=group["device"])
        return {key: value.index_select(0, index) for key, value in group["params"].items()}

    def _predict_entries(self, group: dict, entries) -> List[np.ndarray]:
        """One stacked forward for ``entries`` [(request index, name, X)]
        of one group; outputs in entry order. A batch with stream entries
        is cut on the device, so each entry's copy to the host is its own
        outputs, not the padded batch."""
        names, batch, n_rows, on_device = self._prepare(group, entries)
        with group["lock"]:
            params, rows, m = self._select(group, names)
            if on_device:
                full = batch.new_zeros((m,) + tuple(batch.shape[1:]))
                full[rows] = batch
            else:
                full = np.zeros((m,) + batch.shape[1:], dtype=np.float32)
                full[rows] = batch
                full = torch.from_numpy(full).to(group["device"])
            outputs = self._forward(group, params, full)
        cuts = [(row, n_rows[i], group["out_cols"][name])
                for i, (row, name) in enumerate(zip(rows, names))]
        if on_device:
            return [outputs[row, :n, :cols].cpu().numpy() for row, n, cols in cuts]
        outputs = outputs.cpu().numpy()
        return [outputs[row, :n, :cols] for row, n, cols in cuts]

    @staticmethod
    @torch.inference_mode()
    def _forward(group: dict, params: Tensors, batch: torch.Tensor) -> torch.Tensor:
        """The vmapped forward of (M, rows, width) inputs on the group's
        device: (M, outputs, n_features_out) float32 there."""
        module = group["module"]
        bf16 = group["precision"] == "bf16"
        if group["windowed"]:
            lb, la = group["lookback"], group["lookahead"]
            starts = torch.arange(batch.shape[1] - lb + 1 - la, device=batch.device)
            batch = batch[:, starts[:, None] + torch.arange(lb, device=batch.device)]

        def one(p, x):
            if bf16:
                x = cast(x, torch.bfloat16)
            return cast(first_output(functional_call(module, p, (x,))), torch.float32)

        return vmap(one)(params, batch)


def fleet_scorer_from_models(
    models: Dict[str, Any],
) -> Tuple[Optional[FleetScorer], Dict[str, list], Dict[str, Any]]:
    """
    (scorer, host prefix transformers by machine, models with no fitted
    port estimator, which the server scores one by one) from the models
    as the server loads them.
    """
    from gordo_tpu_torch.builder.fleet_build import _find_torch_estimator, _prefix_transformers

    estimators: Dict[str, BaseTorchEstimator] = {}
    prefixes: Dict[str, list] = {}
    fallback: Dict[str, Any] = {}
    for name, model in models.items():
        est = _find_torch_estimator(model)
        if est is None or not hasattr(est, "spec_"):
            fallback[name] = model
        else:
            estimators[name] = est
            prefixes[name] = _prefix_transformers(model)
    scorer = FleetScorer(estimators) if estimators else None
    return scorer, prefixes, fallback

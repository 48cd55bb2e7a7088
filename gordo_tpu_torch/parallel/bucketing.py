"""
The bucketing compiler (the port of ``gordo_tpu.parallel.bucketing``):
which machines of a fleet train together as one bucket.

A machine's spec is its canonical model definition and its
(n_features, n_features_out) from its tag lists; a grouping policy maps
it to a :class:`ProgramKey`, and machines sharing a key train as one
:class:`~gordo_tpu_torch.parallel.fleet.FleetTrainer` fit:

- ``exact`` (the default): one bucket per exact (canonical definition,
  n_features, n_features_out);
- ``padded``: machines of one definition whose widths round to the same
  powers of two share a bucket at the padded widths; the trainer masks
  the pad columns out of the loss, and serving strips them.

Plans are deterministic from the config alone (first-seen order of
buckets and of machines). The data-length grid (``timestep_bucket``) is
chosen later, once the data is fetched. The JAX package buckets to share
compiled XLA programs; the eager port has no compile to share, but keeps
the same grouping, so a bucket is the unit the fleet trains at once and
``--bucket-policy`` means the same in both packages.
"""

import dataclasses
import json
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple, Union

from gordo_tpu_torch.machine import Machine


#: the largest bucket any axis may round up to — a guard against a
#: corrupt length (an off-by-miles n would otherwise spin the doubling
#: loop toward overflow and allocate a grid nobody meant to ask for)
MAX_BUCKET = 1 << 30


def _canonical_model_key(model_config: dict) -> str:
    return json.dumps(model_config, sort_keys=True, default=str)


def _check_bucket_args(n: int, min_bucket: int, axis: str) -> None:
    """Shared degenerate-input guard for the bucket helpers: a silent
    round-up of n=0 to ``min_bucket`` is indistinguishable from a real
    length and has shipped empty grids before — fail loudly instead."""
    if int(n) != n or int(min_bucket) != min_bucket:
        raise ValueError(
            f"{axis} bucket arguments must be integers, got n={n!r}, "
            f"min_bucket={min_bucket!r}"
        )
    if n <= 0:
        raise ValueError(
            f"{axis} length must be >= 1 to bucket, got {n} (an empty "
            "axis has no bucket; padding it up would hide the bug)"
        )
    if min_bucket < 1 or (min_bucket & (min_bucket - 1)) != 0:
        raise ValueError(
            f"min_bucket must be a power of two >= 1, got {min_bucket} "
            "(a non-power-of-two floor would break the shared-geometry "
            "guarantee: two lengths could round to buckets that are not "
            "supersets of each other)"
        )
    if n > MAX_BUCKET:
        raise ValueError(
            f"{axis} length {n} exceeds the largest supported bucket "
            f"({MAX_BUCKET}); refusing to round it up"
        )


def timestep_bucket(n: int, min_bucket: int = 256) -> int:
    """
    Round a data length up to the next power-of-two bucket (>= the
    ``min_bucket`` floor). Raises :class:`ValueError` on degenerate
    inputs — ``n <= 0``, a non-power-of-two ``min_bucket``, or an ``n``
    past :data:`MAX_BUCKET` — instead of returning a bucket that cannot
    be told from a real one.
    """
    _check_bucket_args(n, min_bucket, axis="timestep")
    bucket = min_bucket
    while bucket < n:
        bucket *= 2
    return bucket


def dimension_bucket(n: int, min_bucket: int = 1) -> int:
    """
    The feature/width-axis twin of :func:`timestep_bucket`: smallest
    power of two >= ``max(n, min_bucket)``. The padded bucket policy
    rounds n_features / n_features_out through this, so ragged widths
    share one program with <2x padded compute per axis. Same
    degenerate-input discipline as :func:`timestep_bucket`.
    """
    _check_bucket_args(n, min_bucket, axis="dimension")
    bucket = min_bucket
    while bucket < n:
        bucket *= 2
    return bucket


def machine_dims(machine: Machine) -> Tuple[int, int]:
    """Config-time (n_features, n_features_out) — tag-list widths. The
    build-time dims may differ when a prefix transformer changes the
    column count; the plan is a config-time estimate."""
    return (
        len(machine.dataset.tag_list),
        len(machine.dataset.target_tag_list),
    )


@dataclasses.dataclass(frozen=True)
class ProgramKey:
    """
    The identity of one bucket: the architecture (the canonical model
    definition as JSON) and the widths it trains at, stamped with the
    policy that assigned them.
    """

    model_key: str
    n_features: int
    n_features_out: int
    policy: str = "exact"


@dataclasses.dataclass
class BucketPlan:
    """One planned bucket: its machines, their config-time widths, and the
    widths the bucket trains at."""

    key: ProgramKey
    machines: List[Machine]
    dims: List[Tuple[int, int]]  # per-machine (n_features, n_features_out)

    @property
    def n_machines(self) -> int:
        return len(self.machines)

    def padding_waste(self) -> Dict[str, float]:
        """
        Planned share of pad cells per axis, in [0, 1): ``features`` of
        the (M, n_features) input-width cells, ``features_out`` of the
        output ones; 0.0 when the bucket is exactly its machines' shape.
        """
        m = max(1, len(self.dims))
        f_prog = max(1, self.key.n_features)
        fo_prog = max(1, self.key.n_features_out)
        f_real = sum(f for f, _ in self.dims)
        fo_real = sum(fo for _, fo in self.dims)
        return {
            "features": 1.0 - f_real / (m * f_prog),
            "features_out": 1.0 - fo_real / (m * fo_prog),
        }


class BucketPolicy:
    """
    A grouping policy: machines -> planned buckets. Subclasses give the
    key a machine maps to and the widths a bucket trains at; planning
    (stable grouping in first-seen machine order) is shared, so a plan
    depends on the config alone.
    """

    name: str = "abstract"

    def machine_key(self, machine: Machine) -> ProgramKey:
        raise NotImplementedError

    def plan(self, machines: Sequence[Machine]) -> List[BucketPlan]:
        """Group ``machines`` into buckets, keeping the first-seen order of
        buckets and of the machines in each."""
        plans: Dict[ProgramKey, BucketPlan] = {}
        for machine in machines:
            key = self.machine_key(machine)
            plan = plans.get(key)
            if plan is None:
                plan = plans[key] = BucketPlan(key=key, machines=[], dims=[])
            plan.machines.append(machine)
            plan.dims.append(machine_dims(machine))
        return list(plans.values())

    def program_dims(
        self, widths: Sequence[int], out_widths: Sequence[int]
    ) -> Tuple[int, int]:
        """
        The (n_features, n_features_out) a bucket trains at, from its
        machines' widths after their prefix transformers (which may change
        the column count of the config's tag lists).
        """
        raise NotImplementedError


class ExactBucketPolicy(BucketPolicy):
    """One bucket per exact (canonical definition, n_features,
    n_features_out)."""

    name = "exact"

    def machine_key(self, machine: Machine) -> ProgramKey:
        f, f_out = machine_dims(machine)
        return ProgramKey(_canonical_model_key(machine.model), f, f_out, self.name)

    def program_dims(self, widths, out_widths):
        f, f_out = set(widths), set(out_widths)
        if len(f) != 1 or len(f_out) != 1:
            # exact buckets are uniform by construction; ragged widths
            # here mean a data-dependent transformer broke the contract
            raise ValueError(
                "exact bucket has ragged post-transform widths "
                f"(n_features {sorted(f)}, n_features_out {sorted(f_out)})"
            )
        return f.pop(), f_out.pop()


class PaddedBucketPolicy(BucketPolicy):
    """
    Machines of one definition whose widths round to the same powers of
    two share one bucket at the padded widths. Pad columns are zero on
    input (zero activations and gradients through the first layer) and
    weighted out of the loss, validation and early stopping on output
    (``StackedData.feature_out_weight``); the power-of-two rounding bounds
    the waste under 2x per axis.
    """

    name = "padded"

    def __init__(self, min_bucket: int = 1):
        self.min_bucket = int(min_bucket)
        _check_bucket_args(1, self.min_bucket, axis="dimension")

    def machine_key(self, machine: Machine) -> ProgramKey:
        f, f_out = machine_dims(machine)
        return ProgramKey(
            _canonical_model_key(machine.model),
            dimension_bucket(f, self.min_bucket),
            dimension_bucket(f_out, self.min_bucket),
            self.name,
        )

    def program_dims(self, widths, out_widths):
        return (
            dimension_bucket(max(widths), self.min_bucket),
            dimension_bucket(max(out_widths), self.min_bucket),
        )


#: the ``--bucket-policy`` vocabulary
BUCKET_POLICIES = ("exact", "padded")


def get_policy(policy: Union[str, BucketPolicy, None]) -> BucketPolicy:
    """A ``--bucket-policy`` value (or a ready policy; None is ``exact``)
    as a policy."""
    if policy is None:
        return ExactBucketPolicy()
    if isinstance(policy, BucketPolicy):
        return policy
    if policy == "exact":
        return ExactBucketPolicy()
    if policy == "padded":
        return PaddedBucketPolicy()
    raise ValueError(f"Unknown bucket policy {policy!r}; available: {BUCKET_POLICIES}")


def plan_padding_waste(plans: Sequence[BucketPlan]) -> float:
    """
    The planned share of pad cells over both feature axes of every
    bucket's (machines x width) stack, in [0, 1): 0.0 for an exact plan,
    under 0.5 an axis for a padded one.
    """
    total = 0
    pad = 0
    for plan in plans:
        m = len(plan.dims)
        total += m * (plan.key.n_features + plan.key.n_features_out)
        pad += sum(
            (plan.key.n_features - f) + (plan.key.n_features_out - fo)
            for f, fo in plan.dims
        )
    return pad / total if total else 0.0


def bucket_machines(
    machines: List[Machine],
) -> Dict[Tuple[str, int, int], List[Machine]]:
    """
    The exact policy's plan as a dict: machines by (canonical model
    definition, n_features, n_features_out).
    """
    buckets: Dict[Tuple[str, int, int], List[Machine]] = defaultdict(list)
    for plan in ExactBucketPolicy().plan(machines):
        key = (plan.key.model_key, plan.key.n_features, plan.key.n_features_out)
        buckets[key].extend(plan.machines)
    return dict(buckets)

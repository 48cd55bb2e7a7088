"""
The shipped game days (the port of ``gordo_tpu.scenario.library``): six
scenario documents, as Python dicts in the YAML grammar, parsed by the
same strict :func:`~gordo_tpu_torch.scenario.timeline.parse_scenario` as
a user's file. ``examples/scenarios/`` holds the same documents as YAML,
read by the port's YAML reader; ``tests/test_torch_scenario.py`` holds
the two equal, and both equal to JAX's.

Fault targets are computed: the replica a scenario kills or flaps is the
ring owner of a streamed machine (``HashRing(rids).owner``), so the
failure hits live streams. ``rolling-upgrade`` re-stamps the AOT program
store, which the port lacks: it parses, ``gameday list`` marks it, and
``gameday run`` skips it (``Scenario.unported``).
"""

from typing import Dict, Sequence

from gordo_tpu_torch.scenario.plane import GAMEDAY_MACHINES
from gordo_tpu_torch.scenario.timeline import Scenario, parse_scenario

#: every scenario's base SLO: zero unstructured errors, CPU-lenient
#: predict latency (game days measure survival, not speed)
_BASE_OBJECTIVES = [
    {
        "signal": "unstructured_error_rate",
        "threshold": 0.0,
        "budget": 0.001,
        "window_s": 300,
    },
    {
        "signal": "predict_p99_ms",
        "threshold": 2500,
        "budget": 0.5,
        "window_s": 300,
    },
]


def _owner(rids: Sequence[str], machine: str) -> str:
    from gordo_tpu_torch.router.ring import HashRing

    return HashRing(list(rids)).owner(machine)


def scenario_documents() -> Dict[str, dict]:
    """The raw scenario documents, keyed by name (the source of truth
    the YAML files in examples/scenarios/ mirror verbatim)."""
    streamed = GAMEDAY_MACHINES[0]
    region_victim = _owner(["r0", "r1", "r2"], streamed)
    flap_victim = _owner(["r0", "r1"], streamed)
    docs: Dict[str, dict] = {}

    docs["region-loss"] = {
        "name": "region-loss",
        "description": (
            "A replica drops off the network mid-stream (connection "
            "refused, the SIGKILL shape) and later comes back; streams "
            "must resume on the ring successor bit-identically."
        ),
        "plane": {"replicas": 3},
        "workload": {
            "streams": 6,
            "stream_interval_s": "400ms",
            "rows_per_update": 4,
            "requests_per_s": 3,
        },
        "duration_s": "10s",
        "timeline": [
            {"at": "3s", "action": "kill_replica", "replica": region_victim},
            {
                "at": "6500ms",
                "action": "restart_replica",
                "replica": region_victim,
            },
        ],
        "slo": {
            "objectives": [
                *_BASE_OBJECTIVES,
                {
                    "signal": "shed_rate",
                    "threshold": 0.9,
                    "budget": 0.5,
                    "window_s": 300,
                },
            ]
        },
        "expect": {"min_stream_resumes": 1, "bit_identity": True},
    }

    docs["thundering-herd"] = {
        "name": "thundering-herd",
        "description": (
            "A synthetic arrival burst slams the per-session backlog "
            "bound; the plane sheds with Retry-After instead of "
            "melting, clients honor the shed, and the stream stays "
            "bit-identical once the herd passes."
        ),
        "plane": {"replicas": 2},
        "workload": {
            "streams": 5,
            "stream_interval_s": "300ms",
            "rows_per_update": 4,
            "requests_per_s": 6,
        },
        "duration_s": "10s",
        "timeline": [
            {
                "at": "3s",
                "action": "arm_faults",
                "spec": (
                    f"stream:burst:{GAMEDAY_MACHINES[1]}"
                    "@rate:12@attempts:2"
                ),
            },
            {"at": "5s", "action": "disarm_faults"},
        ],
        "slo": {
            "objectives": [
                *_BASE_OBJECTIVES,
                {
                    "signal": "shed_rate",
                    "threshold": 0.95,
                    "budget": 0.9,
                    "window_s": 300,
                },
            ]
        },
        "expect": {
            "fault_sites": ["stream"],
            "min_sheds_honored": 1,
            "bit_identity": True,
        },
    }

    docs["rolling-upgrade"] = {
        "name": "rolling-upgrade",
        "description": (
            "The AOT program manifest is re-stamped for a different "
            "jaxlib, then replicas restart one at a time: each fresh "
            "process must take the manifest_mismatch fallback (silent "
            "retrace) with zero request failures and bit-identical "
            "scores."
        ),
        "plane": {"replicas": 2},
        "workload": {
            "streams": 4,
            "stream_interval_s": "400ms",
            "rows_per_update": 4,
            "requests_per_s": 3,
        },
        "duration_s": "12s",
        "timeline": [
            {"at": "2500ms", "action": "bump_jaxlib_manifest"},
            {"at": "5s", "action": "restart_replica", "replica": "r0"},
            {"at": "8s", "action": "restart_replica", "replica": "r1"},
        ],
        "slo": {"objectives": [*_BASE_OBJECTIVES]},
        "expect": {"min_stream_resumes": 1, "bit_identity": True},
    }

    docs["slow-drip-drift"] = {
        "name": "slow-drip-drift",
        "description": (
            "Synthetic sensor drift on one machine while traffic "
            "flows; a lifecycle tick must detect it, refit, and "
            "promote a new revision under load without an "
            "unstructured error."
        ),
        "plane": {"replicas": 2},
        "workload": {
            "streams": 4,
            "stream_interval_s": "500ms",
            "rows_per_update": 4,
            "requests_per_s": 2,
        },
        "duration_s": "14s",
        "timeline": [
            {
                "at": "2s",
                "action": "arm_faults",
                "spec": f"drift:shift:{GAMEDAY_MACHINES[1]}@scale:6",
            },
            {"at": "3s", "action": "lifecycle_tick"},
            {"at": "10s", "action": "disarm_faults"},
        ],
        "slo": {"objectives": [*_BASE_OBJECTIVES]},
        "expect": {"fault_sites": ["drift"], "promotions": 1},
    }

    docs["shard-flap"] = {
        "name": "shard-flap",
        "description": (
            "The replica owning a streamed machine flaps (bursts of "
            "consecutive call failures, then recovery, repeating); the "
            "router must eject and re-adopt through half-open probing "
            "while streams resume bit-identically."
        ),
        "plane": {"replicas": 2},
        "workload": {
            "streams": 4,
            "stream_interval_s": "300ms",
            "rows_per_update": 4,
            "requests_per_s": 3,
        },
        "duration_s": "10s",
        "timeline": [
            {
                "at": "2500ms",
                "action": "arm_faults",
                "spec": f"replica:flap:{flap_victim}@burst:3",
            },
            {"at": "7s", "action": "disarm_faults"},
        ],
        "slo": {
            "objectives": [
                *_BASE_OBJECTIVES,
                {
                    "signal": "shed_rate",
                    "threshold": 0.9,
                    "budget": 0.5,
                    "window_s": 300,
                },
            ]
        },
        "expect": {
            "fault_sites": ["replica"],
            "min_stream_resumes": 1,
            "bit_identity": True,
        },
    }

    docs["torn-promotion"] = {
        "name": "torn-promotion",
        "description": (
            "Drift triggers a refit whose promotion is torn mid-copy "
            "(crash during revision assembly); the partial staging dir "
            "must never become latest, and a retry tick under the same "
            "load completes the promotion."
        ),
        "plane": {"replicas": 2},
        "workload": {
            "streams": 4,
            "stream_interval_s": "500ms",
            "rows_per_update": 4,
            "requests_per_s": 2,
        },
        "duration_s": "16s",
        "timeline": [
            {
                "at": "1500ms",
                "action": "arm_faults",
                "spec": (
                    f"drift:shift:{GAMEDAY_MACHINES[2]}@scale:6;"
                    "promote:torn@attempts:1"
                ),
            },
            {"at": "2500ms", "action": "lifecycle_tick"},
            {"at": "9s", "action": "lifecycle_tick"},
            {"at": "14s", "action": "disarm_faults"},
        ],
        "slo": {"objectives": [*_BASE_OBJECTIVES]},
        "expect": {
            "fault_sites": ["drift", "promote"],
            "promotions": 1,
        },
    }

    return docs


def builtin_scenarios() -> Dict[str, Scenario]:
    """Every shipped scenario, parsed and validated (``rolling-upgrade``
    among them: it parses, though the port does not run it)."""
    return {
        name: parse_scenario(doc, name=name)
        for name, doc in scenario_documents().items()
    }


def get_scenario(name: str) -> Scenario:
    scenarios = builtin_scenarios()
    if name not in scenarios:
        raise KeyError(
            f"Unknown scenario {name!r}; shipped: {sorted(scenarios)}"
        )
    return scenarios[name]

"""
Per-machine fault domains (the port of ``gordo_tpu.robustness``): the
fault-injection registry whose seams the fleet builder, the fleet
trainer, checkpoints, the multi-worker ledger, the server, the batcher,
the router, the streams and the lifecycle read
(:mod:`.faults`). The degradation paths
themselves live where the work happens: the non-finite quarantine in
``parallel.fleet``, isolated fetch and build failures in
``builder.fleet_build``, and the per-machine fault domain of a
lifecycle tick in ``lifecycle.manager``.
"""

from .faults import (
    FAULT_INJECT_ENV_VAR,
    FAULT_INJECT_FILE_ENV_VAR,
    UNWIRED_SITES,
    WIRED_SITES,
    WORKER_ID_ENV_VAR,
    FaultSpec,
    InjectedFault,
    active_registry,
    arm_file,
    disarm_file,
    inject,
    lease_stall,
    parse_spec,
    precision_degrade,
    replica_fault_action,
    reset,
    stream_fault_action,
    tear_checkpoint_files,
    train_nan_injection,
    worker_die,
)

__all__ = [
    "FAULT_INJECT_ENV_VAR",
    "FAULT_INJECT_FILE_ENV_VAR",
    "UNWIRED_SITES",
    "WIRED_SITES",
    "WORKER_ID_ENV_VAR",
    "FaultSpec",
    "InjectedFault",
    "active_registry",
    "arm_file",
    "disarm_file",
    "inject",
    "lease_stall",
    "parse_spec",
    "precision_degrade",
    "replica_fault_action",
    "reset",
    "stream_fault_action",
    "tear_checkpoint_files",
    "train_nan_injection",
    "worker_die",
]

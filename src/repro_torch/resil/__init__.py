"""Resilience: deterministic fault injection, on-device health guards,
quarantine, and durable snapshots with rollback and auto-resume (the
reference's ``repro.resil``)."""
from repro_torch.resil.faults import (  # noqa: F401
    CORRUPT_MODES, DEFAULT_MAX_ABS, FAULT_KINDS, SimulatedCrash,
    WireFault, corrupt_rows, corrupt_values, make_validated_mixer,
    payload_valid)
from repro_torch.resil.guards import (  # noqa: F401
    GUARD_COUNTERS, GuardSpec, init_node_guard, tripped_nodes,
    wire_offenders)
from repro_torch.resil.snapshot import Resilience, SnapshotManager  # noqa: F401

"""Federation scheduler: schedule compiler, event-driven outer loop and
the per-round communication ledger (the reference's ``repro.sched``)."""
from repro_torch.sched.ledger import (CommLedger, LedgerEntry,  # noqa: F401
                                      gossip_bytes_per_step,
                                      wire_elem_bytes)
from repro_torch.sched.schedule import (  # noqa: F401
    CHURN_MODES, GOSSIP_MODES, ChurnEvent, FaultEvent, HomogenizeEvent,
    RewireEvent, Schedule, Segment, compile_schedule, fit_every_k,
    idkd_round_steps, parse_churn, parse_faults)
from repro_torch.sched.scheduler import (  # noqa: F401
    CompiledFederationHooks, FederationHooks, run_schedule,
    validate_shard_schedule)

from repro_torch.sched.ledger import CommLedger, wire_elem_bytes  # noqa: F401
from repro_torch.sched.schedule import (HomogenizeEvent,  # noqa: F401
                                        Schedule, Segment, compile_schedule,
                                        fit_every_k, idkd_round_steps)
from repro_torch.sched.scheduler import (  # noqa: F401
    CompiledFederationHooks, FederationHooks, run_schedule)

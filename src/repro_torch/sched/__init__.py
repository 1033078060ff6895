from repro_torch.sched.ledger import CommLedger, wire_elem_bytes  # noqa: F401
from repro_torch.sched.schedule import (HomogenizeEvent,  # noqa: F401
                                        Schedule, Segment, compile_schedule,
                                        idkd_round_steps)
from repro_torch.sched.scheduler import (FederationHooks,  # noqa: F401
                                         run_schedule)

from repro_torch.optim.schedules import constant, cosine, step_decay  # noqa: F401
from repro_torch.optim.sgd import (adamw_init, adamw_update,  # noqa: F401
                                   sgd_init, sgd_update)

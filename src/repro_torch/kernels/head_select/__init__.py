from repro_torch.kernels.head_select.ops import (head_select,  # noqa: F401
                                                head_select_plain)

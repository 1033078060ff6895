from repro_torch.kernels.msp_select.ops import (msp_select,  # noqa: F401
                                               msp_select_plain)

from repro_torch.kernels.head_select.ops import (  # noqa: F401
    head_select, head_select_plain, head_select_stats_plain,
    merge_head_stats_plain)

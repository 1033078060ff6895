from repro_torch.kernels.ssd_scan.ops import (  # noqa: F401
    SSDScanFn, ssd_scan, ssd_scan_bwd, ssd_scan_bwd_plain, ssd_scan_plain)

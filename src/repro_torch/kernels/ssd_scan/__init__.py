from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain  # noqa: F401

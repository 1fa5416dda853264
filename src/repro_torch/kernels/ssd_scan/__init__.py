from .ops import ssd_scan
from .ref import linear_scan_chunked, linear_scan_reference, linear_scan_step

__all__ = ["ssd_scan", "linear_scan_reference", "linear_scan_chunked", "linear_scan_step"]

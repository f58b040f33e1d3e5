from .checkpoint import load_checkpoint, save_checkpoint
from .io_vtk import PVDWriter, write_vtu
from .profiling import RegionTimer, device_trace, write_run_report

__all__ = [
    "load_checkpoint",
    "save_checkpoint",
    "PVDWriter",
    "write_vtu",
    "RegionTimer",
    "device_trace",
    "write_run_report",
]

"""Disk models: the Novikov-Thorne thin disk and the pluggable model
protocol.

Port of `sim5_tpu/disk`, with the bridge to external compiled disk
models (`ExternalDisk`).
"""

from .nt import (
    NTDisk, DISK_NT_OPTION_LUMINOSITY,
    nt_setup, nt_flux, nt_temp, nt_lumi, nt_mdot_for_luminosity,
    nt_sigma, nt_ell, nt_vr, nt_h, nt_dhdr, nt_dump,
)
from .base import DiskModel, ThinDisk
from .external import ExternalDisk, ExternalDiskLibrary

"""Disk models: the Novikov-Thorne thin disk.

Port of `sim5_tpu/disk` (the NT disk; the pluggable model protocol and
the external-library disk wait for later slices).
"""

from .nt import (
    NTDisk, DISK_NT_OPTION_LUMINOSITY,
    nt_setup, nt_flux, nt_temp, nt_lumi, nt_mdot_for_luminosity,
    nt_sigma, nt_ell, nt_vr, nt_h, nt_dhdr, nt_dump,
)

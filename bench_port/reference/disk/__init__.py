"""The Novikov-Thorne thin disk (a copy of the port's `disk/nt.py`)."""

from .nt import NTDisk, nt_setup, nt_flux

"""Pluggable disk-model protocol.

Port of `sim5_tpu/disk/base.py`.  The reference exposes a runtime
`dlopen` ABI for external disk models (sim5disk.c:55-111) and a Python
class layer (sim5diskmodel.py:19-200); here, as in the JAX package, a
disk model is any object with these methods on tensors.
"""

import dataclasses
from typing import Protocol, runtime_checkable

import torch

from .. import consts
from . import nt as _nt


@runtime_checkable
class DiskModel(Protocol):
    """Disk model interface (mirrors the diskmodel_* ABI of sim5disk.c)."""

    def r_min(self): ...
    def mdot(self): ...
    def lumi(self): ...
    def flux(self, r): ...
    def t_eff(self, r): ...
    def sigma(self, r): ...
    def ell(self, r): ...
    def vr(self, r): ...
    def h(self, r): ...
    def dhdr(self, r): ...


@dataclasses.dataclass(frozen=True)
class ThinDisk:
    """Novikov-Thorne thin disk as a DiskModel.

    (reference: DiskModel_ThinDisk, python/sim5diskmodel.py:70-96)
    """
    params: _nt.NTDisk

    @classmethod
    def create(cls, bh_mass, bh_spin, mdot_or_L, alpha=0.1, options=0,
               device=None):
        return cls(_nt.nt_setup(bh_mass, bh_spin, mdot_or_L, alpha, options,
                                device=device))

    def r_min(self):
        return self.params.rms

    def mdot(self):
        return self.params.mdot

    def lumi(self):
        return _nt.nt_lumi(self.params)

    def flux(self, r):
        return _nt.nt_flux(self.params, r)

    def t_eff(self, r):
        """Effective temperature [K] from local flux."""
        return (torch.clamp(self.flux(r), min=0.0) / consts.sb_sigma) ** 0.25

    def sigma(self, r):
        return _nt.nt_sigma(self.params, r)

    def ell(self, r):
        return _nt.nt_ell(self.params, r)

    def vr(self, r):
        return _nt.nt_vr(self.params, r)

    def h(self, r):
        return _nt.nt_h(self.params, r)

    def dhdr(self, r):
        return _nt.nt_dhdr(self.params, r)

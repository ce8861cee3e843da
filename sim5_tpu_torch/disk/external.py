"""Bridge for external compiled disk models (the reference's dlopen ABI).

Port of `sim5_tpu/disk/external.py`.  The reference loads any shared
library implementing the ``diskmodel_*`` C ABI (src/sim5disk.c:55-111;
ctypes twin python/sim5diskmodel.py:101-200): that is how slim disks and
other models plug into sim5.  A per-ray callback into a ``.so`` cannot run
on the card, so the bridge samples the compiled model once on the host,
on a radial grid logarithmic in (r - r_min), and puts the samples on a
device as interpolation tables (`special/interp.py`); the raytracer then
evaluates them in batches there.

Usage:
    disk = ExternalDisk.create("libmydisk.so", M=10.0, a=0.7,
                               params="mdot=0.1,alpha=0.1")
    rt = DiskRaytrace(10.0, 0.7, 10.0, disk, DiskSpectrum_BlackBody())
"""

import ctypes
import dataclasses

import numpy as np
import torch

from .. import consts
from ..core.metric import default_device
from ..special.interp import (Interp, interp_init, interp_eval,
                              INTERP_TYPE_LOGLIN,
                              INTERP_OPT_ALLOW_EXTRAPOLATION)


class ExternalDiskLibrary:
    """ctypes binding of the ``diskmodel_*`` shared-library ABI, on the
    host only: the function set of the reference's loader
    (sim5disk.c:89-104), init/done/name/params/r_min/mdot/lumi/flux/
    sigma/ell/vr/h/dhdr.
    """

    _SCALAR_FNS = ("r_min", "mdot", "lumi")
    _RADIAL_FNS = ("flux", "sigma", "ell", "vr", "h", "dhdr")

    def __init__(self, path, M, a, params=""):
        self.lib = ctypes.cdll.LoadLibrary(path)
        self.lib.diskmodel_init.argtypes = [ctypes.c_double, ctypes.c_double,
                                            ctypes.c_char_p]
        self.lib.diskmodel_init.restype = ctypes.c_int
        self.lib.diskmodel_done.argtypes = []
        self.lib.diskmodel_done.restype = None
        try:
            self.lib.diskmodel_name.argtypes = []
            self.lib.diskmodel_name.restype = ctypes.c_char_p
        except AttributeError:
            pass
        for fn in self._SCALAR_FNS:
            f = getattr(self.lib, "diskmodel_" + fn)
            f.argtypes = []
            f.restype = ctypes.c_double
        for fn in self._RADIAL_FNS:
            # the reference's C loader binds `diskmodel_ell` while its
            # Python layer binds `diskmodel_l` (sim5diskmodel.py:148);
            # accept either symbol name
            try:
                f = getattr(self.lib, "diskmodel_" + fn)
            except AttributeError:
                if fn != "ell":
                    raise
                f = getattr(self.lib, "diskmodel_l")
            f.argtypes = [ctypes.c_double]
            f.restype = ctypes.c_double
            setattr(self, "_f_" + fn, f)
        rc = self.lib.diskmodel_init(float(M), float(a),
                                     str(params).encode())
        if rc not in (0, None):
            raise RuntimeError(
                f"diskmodel_init({path!r}) failed with code {rc}")
        self.name = ""
        try:
            self.name = (self.lib.diskmodel_name() or b"").decode()
        except AttributeError:
            pass
        self.r_min = float(self.lib.diskmodel_r_min())
        self.mdot = float(self.lib.diskmodel_mdot())
        self.lumi = float(self.lib.diskmodel_lumi())

    def sample(self, fn, radii):
        f = getattr(self, "_f_" + fn)
        return np.asarray([f(float(r)) for r in radii])

    def close(self):
        if self.lib is not None:
            self.lib.diskmodel_done()
            self.lib = None


def _table(u, vals, device):
    """Linear-in-y table on a log grid (ell/vr/h/dhdr may be <= 0)."""
    return interp_init(u, vals, INTERP_TYPE_LOGLIN,
                       INTERP_OPT_ALLOW_EXTRAPOLATION, device)


@dataclasses.dataclass(frozen=True)
class ExternalDisk:
    """A compiled external disk model, sampled to tables on a device.

    Satisfies the `DiskModel` protocol (disk/base.py): every method is a
    batched interpolation on the tables' device.  The abscissa is
    logarithmic in (r - r_min): quantities with an inner-edge zero behave
    like powers of (r - r_min) there (the NT flux ~ 1 - sqrt(rin / r)), so
    log-flux is nearly linear across the edge.  Radii outside the sampled
    range read the edge values (the raytracer masks off-disk radii).

    Precision: the tables are f64, and every method evaluates in f64 and
    returns the query's floating dtype (a Python number or a non-float
    query gives f64).  An f32 `DiskRaytrace` thus gets the f64 table's
    value rounded once to f32, where the JAX package under
    `enable_x64(False)` interpolates in f32.
    """
    rmin_: torch.Tensor
    mdot_: torch.Tensor
    lumi_: torch.Tensor
    shift_: torch.Tensor   # abscissa shift: u = r - shift_
    t_flux: Interp         # log F on the log-u grid (F > 0 inside the disk)
    t_sigma: Interp        # log Sigma
    t_ell: Interp
    t_vr: Interp
    t_h: Interp
    t_dhdr: Interp
    flux_logy: bool = True
    sigma_logy: bool = True

    @classmethod
    def create(cls, path, M, a, params="", n_samples=8192, r_max=1e6,
               keep_library=False, device=None):
        """Load `path` (a diskmodel_* .so), sample its radial structure on
        an `n_samples`-point grid logarithmic in (r - r_min) over (r_min,
        r_max], and build the tables on `device` (the card unless the
        caller asks for the CPU).  The library is closed afterwards unless
        `keep_library` (then it is returned as second value).
        """
        dev = default_device(device)
        lib = ExternalDiskLibrary(path, M, a, params)
        shift = lib.r_min
        u = np.geomspace(shift * 1e-8, r_max - shift, n_samples)
        radii = shift + u
        s = {fn: lib.sample(fn, radii) for fn in lib._RADIAL_FNS}
        flux_logy = bool((s["flux"] > 0.0).all())
        sigma_logy = bool((s["sigma"] > 0.0).all())

        def scalar(v):
            return torch.tensor(v, dtype=torch.float64, device=dev)

        self = cls(
            rmin_=scalar(lib.r_min), mdot_=scalar(lib.mdot),
            lumi_=scalar(lib.lumi), shift_=scalar(shift),
            t_flux=_table(u, np.log(s["flux"]) if flux_logy else s["flux"],
                          dev),
            t_sigma=_table(u, np.log(s["sigma"]) if sigma_logy
                           else s["sigma"], dev),
            t_ell=_table(u, s["ell"], dev),
            t_vr=_table(u, s["vr"], dev),
            t_h=_table(u, s["h"], dev),
            t_dhdr=_table(u, s["dhdr"], dev),
            flux_logy=flux_logy,
            sigma_logy=sigma_logy,
        )
        if keep_library:
            return self, lib
        lib.close()
        return self

    # -- DiskModel protocol -------------------------------------------------

    def r_min(self):
        return self.rmin_

    def mdot(self):
        return self.mdot_

    def lumi(self):
        return self.lumi_

    def _eval(self, tab, r, logy, inside_only=True):
        """(the table at r in f64, the dtype to return: the query's
        floating dtype, f64 for a Python number or a non-float query)."""
        if not isinstance(r, torch.Tensor):
            r = torch.as_tensor(r, dtype=torch.float64)
        dtype = r.dtype if r.is_floating_point() else torch.float64
        r64 = r.to(self.shift_.device, torch.float64)
        # clamp queries to the sampled range: off-disk radii read the
        # edge values
        u = torch.clamp(r64 - self.shift_, torch.exp(tab.x[0]),
                        torch.exp(tab.x[-1]))
        v = interp_eval(tab, u)
        if logy:
            v = torch.exp(v)
        if inside_only:
            v = torch.where(r64 >= self.rmin_, v, 0.0)
        return v, dtype

    def flux(self, r):
        v, dtype = self._eval(self.t_flux, r, self.flux_logy)
        return v.to(dtype)

    def t_eff(self, r):
        f, dtype = self._eval(self.t_flux, r, self.flux_logy)
        return ((torch.clamp(f, min=0.0) / consts.sb_sigma) ** 0.25).to(dtype)

    def sigma(self, r):
        v, dtype = self._eval(self.t_sigma, r, self.sigma_logy)
        return v.to(dtype)

    def ell(self, r):
        v, dtype = self._eval(self.t_ell, r, False, inside_only=False)
        return v.to(dtype)

    def vr(self, r):
        v, dtype = self._eval(self.t_vr, r, False)
        return v.to(dtype)

    def h(self, r):
        v, dtype = self._eval(self.t_h, r, False)
        return v.to(dtype)

    def dhdr(self, r):
        v, dtype = self._eval(self.t_dhdr, r, False)
        return v.to(dtype)

"""Geodesic state and type/status codes.

Port of `sim5_tpu/geodesic/types.py`.  `Geodesic` is a frozen dataclass of
tensors, the batched equivalent of the reference's `geodesic` struct
(sim5kerr-geod.h:42-68): the motion constants, the quartic roots of R(r),
the trajectory type, the theta roots and the key position-integral values.
Batches come from leading dims.
"""

import dataclasses

import numpy as np
import torch

# trajectory type codes (sim5kerr-geod.h:19-23)
GEOD_TYPE_RR = 40       # four real roots; allowed region r > r1
GEOD_TYPE_RR_DBL = 41   # four real roots, double root
GEOD_TYPE_RR_BH = 42    # four real roots; r3 < r < r2 (under horizon)
GEOD_TYPE_RC = 2        # two real + two complex roots; r > r1
GEOD_TYPE_CC = 0        # four complex roots

# status codes (sim5kerr-geod.h:26-37)
GD_OK = 0
GD_ERROR_Q_ZERO = 1
GD_ERROR_BOUND_GEODESIC = 2
GD_ERROR_UNKNOWN_SOLUTION = 3
GD_ERROR_TYPE_RR_DOUBLE = 4
GD_ERROR_TYPE_CC = 5
GD_ERROR_Q_RANGE = 7
GD_ERROR_MUPLUS_RANGE = 8
GD_ERROR_MU0_RANGE = 9
GD_ERROR_MM_RANGE = 10
GD_ERROR_INCL_RANGE = 11
GD_ERROR_SPIN_RANGE = 12


@dataclasses.dataclass(frozen=True)
class Geodesic:
    """Cached data of one (batch of) null geodesic(s); the fields and their
    order are those of the JAX package's `Geodesic`."""
    a: torch.Tensor        # BH spin (clamped)
    alpha: torch.Tensor    # impact parameter (horizontal)
    beta: torch.Tensor     # impact parameter (vertical)
    incl: torch.Tensor     # observer inclination [rad]
    cos_i: torch.Tensor    # cos(incl)
    l: torch.Tensor        # motion constant L_z/E
    q: torch.Tensor        # Carter constant L/E^2
    rr: torch.Tensor       # (...,4) real parts of R(r) roots (real desc first)
    ri: torch.Tensor       # (...,4) imag parts
    nrr: torch.Tensor      # int32 number of real roots
    gtype: torch.Tensor    # int32 trajectory type (GEOD_TYPE_*)
    m2p: torch.Tensor      # theta-root mu_plus^2
    m2m: torch.Tensor      # theta-root mu_minus^2 (note sign convention)
    mm: torch.Tensor       # modulus of theta integrals
    mK: torch.Tensor       # scale of theta integrals
    rp: torch.Tensor       # periastron radius
    Rpc: torch.Tensor      # R-integral infinity..periastron
    Tpp: torch.Tensor      # T-integral -mu_plus..mu_plus
    Tip: torch.Tensor      # T-integral cos_i..mu_plus
    status: torch.Tensor   # int32 GD_* status (0 = usable)
    # (...,4) low parts of rr: root_i = rr_i + rr_lo_i as a two-float pair,
    # so root differences stay accurate to ~1 ulp of the difference
    rr_lo: torch.Tensor = None

    @property
    def ok(self):
        return self.status == GD_OK

    def root_diff(self, i, j):
        """Accurate root difference rr[i] - rr[j] using the two-float low
        parts (exact hi-difference by Sterbenz for close roots)."""
        d = self.rr[..., i] - self.rr[..., j]
        if self.rr_lo is None:
            return d
        return d + (self.rr_lo[..., i] - self.rr_lo[..., j])

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_numpy(cls, d, device="cuda"):
        """Geodesic from a dict of numpy arrays (e.g. the fields of a
        `sim5_tpu` Geodesic, `g._asdict()`), on `device` (the card unless
        the caller asks for the CPU); dtypes are kept."""
        return cls(**{f.name: (None if d.get(f.name) is None else
                               torch.as_tensor(np.array(d[f.name]),
                                               device=device))
                      for f in dataclasses.fields(cls)})

    def numpy(self):
        """The geodesic as a dict of numpy arrays (the inverse of
        `from_numpy`)."""
        return {f.name: (None if getattr(self, f.name) is None else
                         getattr(self, f.name).detach().cpu().numpy())
                for f in dataclasses.fields(self)}

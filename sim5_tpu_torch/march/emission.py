"""Emission and absorption models that the march kernel evaluates inside
its step loop.

The fused radiative transfer of the march kernel
(`kernel_march.raytrace_kernel`) takes any emissivity j and absorption
alpha that `raytrace_pallas` would take: a torch callable
`(t, r, m, phi) -> tensor` of the elementwise ops of `model_trace.OPS`,
traced into a generated build of the kernel (`model_trace.py`).  Besides,
one parametrised family is compiled into the kernel's own library,
`GaussianSource`, whose parameters go to the kernel by value: the
Gaussian blobs and constants of the Pallas march tests, the spot and
flare of the march tests, example 11's torus, and example 07's orbiting
spot as a 3-D source, with no build at first use.

A `GaussianSource` is also callable on tensors, `model(t, r, m, phi)`, which
is its plain torch form: the plain version of the kernel and the loop
engine of `render.lightcurve.volume_image` call it like any other
callable, and it is what is traced when it meets a traced model in one
march.
"""

import dataclasses
import math

import torch

from .model_trace import trace_model

# the values of the kernel's `rt` argument
RT_NONE = 0                  # geometry only
RT_EMISSION = 1              # I += j dl
RT_EMISSION_ABSORPTION = 2   # I += j e^{-tau} s_eff, tau += alpha dl


@dataclasses.dataclass(frozen=True)
class GaussianSource:
    """j(t, r, m, phi) = amp * exp(-[((rho - center) inv_width)^2
                                    + (z inv_height)^2
                                    + ((t - t_center) inv_duration)^2
                                    + (rho dphi inv_arc)^2] / 2)

    with z = r m, rho = r, or the cylindrical radius r sqrt(max(1 - m^2, 0))
    when `cylindrical`, and dphi = phi - phi_center - omega t wrapped into
    [-pi, pi) (`hotspot_lightcurve`'s wrap): with `inv_arc` > 0 a spot
    centred at azimuth phi_center + omega t, orbiting at the angular
    velocity `omega`, of arc length 1 / inv_arc.  An inverse width of 0
    means the source is unbounded along that direction; with all four 0
    the source is the constant `amp`.  With inv_arc == 0 the arc term is
    not evaluated at all, so a source that does not orbit gives the same
    bits as the family without it.
    """
    amp: float = 1.0
    center: float = 0.0
    inv_width: float = 0.0
    inv_height: float = 0.0
    cylindrical: bool = False
    t_center: float = 0.0
    inv_duration: float = 0.0
    phi_center: float = 0.0
    omega: float = 0.0
    inv_arc: float = 0.0

    def __call__(self, t, r, m, phi):
        """The plain torch form, in the order of operations the kernel
        uses (`gauss` in csrc/march.cu)."""
        rho = (r * torch.sqrt(torch.clamp(1.0 - m * m, min=0.0))
               if self.cylindrical else r)
        d = (rho - self.center) * self.inv_width
        z = r * m * self.inv_height
        w = (t - self.t_center) * self.inv_duration
        s = d * d + z * z + w * w
        if self.inv_arc != 0.0:
            dphi = torch.remainder(phi - self.phi_center - self.omega * t
                                   + math.pi, 2.0 * math.pi) - math.pi
            e = rho * dphi * self.inv_arc
            s = s + e * e
        return self.amp * torch.exp(-0.5 * s)

    def params(self):
        """The parameters as the kernel takes them, in its order."""
        return (float(self.amp), float(self.center), float(self.inv_width),
                float(self.inv_height), float(self.t_center),
                float(self.inv_duration), float(self.phi_center),
                float(self.omega), float(self.inv_arc),
                int(bool(self.cylindrical)))


def is_family(emissivity, absorption):
    """Whether the kernel's compiled-in family takes the pair: each model a
    `GaussianSource` or None."""
    return all(m is None or isinstance(m, GaussianSource)
               for m in (emissivity, absorption))


def rt_mode(emissivity, absorption):
    """The kernel's `rt` value for a pair of models (any callables or
    None); ValueError for an absorption without an emissivity."""
    if emissivity is None:
        if absorption is not None:
            raise ValueError("absorption needs an emissivity")
        return RT_NONE
    return RT_EMISSION if absorption is None else RT_EMISSION_ABSORPTION


def prepare(emissivity, absorption):
    """(rt, emissivity, absorption) of one march: the kernel's `rt` value
    and the pair as the kernel takes it, a family pair as it is, any other
    with each model traced (`model_trace.trace_model`: a `TracedModel`,
    with the numbers the callable reads now).  Raises what `trace_model`
    raises for a callable the kernel cannot evaluate, and what `rt_mode`
    raises."""
    rt = rt_mode(emissivity, absorption)
    if rt == RT_NONE or is_family(emissivity, absorption):
        return rt, emissivity, absorption
    return rt, trace_model(emissivity), (
        None if absorption is None else trace_model(absorption))

"""Emission and absorption models that the march kernel evaluates inside
its step loop.

A CUDA kernel cannot call a Python callable, so the fused radiative
transfer of the march kernel (`kernel_march.raytrace_kernel`) takes its
emissivity j and absorption alpha from one compiled-in, parametrised
family, `GaussianSource`.  Its parameters go to the kernel by value.  The
family covers every model the repository uses: the Gaussian blobs and
constants of the Pallas march tests, the spot and flare of the march
tests, and example 11's torus.

A `GaussianSource` is also callable on tensors, `model(t, r, m, phi)`, which
is its plain torch form: the plain version of the kernel and the loop
engine of `render.lightcurve.volume_image` call it like any other
callable.
"""

import dataclasses

import torch

# the values of the kernel's `rt` argument
RT_NONE = 0                  # geometry only
RT_EMISSION = 1              # I += j dl
RT_EMISSION_ABSORPTION = 2   # I += j e^{-tau} s_eff, tau += alpha dl


@dataclasses.dataclass(frozen=True)
class GaussianSource:
    """j(t, r, m, phi) = amp * exp(-[((rho - center) inv_width)^2
                                    + (z inv_height)^2
                                    + ((t - t_center) inv_duration)^2] / 2)

    with z = r m and rho = r, or the cylindrical radius
    r sqrt(max(1 - m^2, 0)) when `cylindrical`.  An inverse width of 0
    means the source is unbounded along that direction; with all three 0
    the source is the constant `amp`.
    """
    amp: float = 1.0
    center: float = 0.0
    inv_width: float = 0.0
    inv_height: float = 0.0
    cylindrical: bool = False
    t_center: float = 0.0
    inv_duration: float = 0.0

    def __call__(self, t, r, m, phi):
        """The plain torch form, in the order of operations the kernel
        uses (`gauss` in csrc/march.cu)."""
        rho = (r * torch.sqrt(torch.clamp(1.0 - m * m, min=0.0))
               if self.cylindrical else r)
        d = (rho - self.center) * self.inv_width
        z = r * m * self.inv_height
        w = (t - self.t_center) * self.inv_duration
        return self.amp * torch.exp(-0.5 * (d * d + z * z + w * w))

    def params(self):
        """The parameters as the kernel takes them, in its order."""
        return (float(self.amp), float(self.center), float(self.inv_width),
                float(self.inv_height), float(self.t_center),
                float(self.inv_duration), int(bool(self.cylindrical)))


def rt_mode(emissivity, absorption):
    """The kernel's `rt` value for a pair of models; raises on a model the
    kernel cannot evaluate."""
    for name, model in (("emissivity", emissivity), ("absorption", absorption)):
        if model is not None and not isinstance(model, GaussianSource):
            raise TypeError(
                f"the march kernel evaluates {name} models of the "
                f"GaussianSource family only, not {type(model).__name__}; "
                "use volume_image(engine='loop') for any callable")
    if emissivity is None:
        if absorption is not None:
            raise ValueError("absorption needs an emissivity")
        return RT_NONE
    return RT_EMISSION if absorption is None else RT_EMISSION_ABSORPTION

"""Volume radiative transfer: images and light curves of a 3-D source.

Port of `sim5_tpu/render/lightcurve.py` (the volume path, BASELINE config
#4): the analytic engine supplies exact initial conditions on a sphere
r = r_start (position and momentum of each pixel's geodesic), and the
stepwise engine marches every ray inward, accumulating
I = int j e^{-tau} dl with tau = int alpha dl toward the observer.

Two march engines:

* "loop" (the JAX package's "xla"): a torch loop over `raytrace_step` in
  any dtype, with any callable emissivity and absorption;
* "kernel" (the JAX package's "pallas"): the f32 march kernel with fused
  transfer (`march.kernel_march.raytrace_kernel`), whose emissivity and
  absorption are `march.emission.GaussianSource` models.

Still to port: the azimuth stage of the seed (`axisymmetric=False`), the
differentiable "scan" engine and `hotspot_lightcurve`.
"""

import dataclasses

import numpy as np
import torch

from ..core import r_bh
from ..core.metric import default_device
from ..geodesic import (geodesic_init_inf, geodesic_P_int,
                        geodesic_position_rad, geodesic_position_pol,
                        geodesic_momentum)
from ..march import raytrace_prepare, raytrace_step, raytrace_kernel
from .image import image_grid


def _volume_seed_geom(a, incl, npix, rmax, r_start, dtype, device):
    """Per-pixel analytic seed without the azimuth: (geodesic, valid mask,
    P, r, m) at r = r_start."""
    alpha, beta = image_grid(npix, npix, rmax, dtype=dtype, device=device)
    g = geodesic_init_inf(incl, a, alpha, beta)
    ok = g.status == 0
    P0 = geodesic_P_int(g, torch.full(alpha.shape, r_start, dtype=dtype,
                                      device=alpha.device), 0)
    ok = ok & torch.isfinite(P0)
    P0s = torch.where(ok, P0, 1e-3)
    r0 = geodesic_position_rad(g, P0s)
    m0 = geodesic_position_pol(g, P0s)
    return g, ok, P0s, r0, m0


def _volume_seed_pack(g, ok, P0s, r0, m0, phi0, a, t0, r_start, precision):
    """March state of the seeded rays (and the valid mask): invalid pixels
    get a finite dummy ray that `ok` keeps inactive."""
    ok = ok & torch.isfinite(r0) & torch.isfinite(m0) & torch.isfinite(phi0)
    r0 = torch.where(ok, r0, r_start)
    m0 = torch.where(ok, m0, 0.0)
    phi0 = torch.where(ok, phi0, 0.0)
    k = geodesic_momentum(g, P0s, r0, m0)
    # marching convention: k[2] of geodesic_momentum is dm/dP-signed; the
    # integrator treats k^2 as dtheta/dlambda -> flip
    k = torch.cat([k[..., :2], -k[..., 2:3], k[..., 3:]], -1)
    k = torch.where(ok[..., None], k, torch.stack(
        [torch.ones_like(r0), -torch.ones_like(r0), torch.zeros_like(r0),
         torch.zeros_like(r0)], -1))
    x0 = torch.stack([torch.full_like(r0, t0), r0, m0, phi0], -1)
    st = raytrace_prepare(a, x0, k, precision=precision)
    return st, ok


def _volume_seed(a, incl, t0, npix, rmax, r_start, precision,
                 axisymmetric=False, dtype=torch.float64, device=None):
    """Seed every pixel's ray on its analytic geodesic at r = r_start:
    returns (march state, valid mask).  axisymmetric=True starts every ray
    at phi = 0 and skips the azimuth stage (see volume_image)."""
    if not axisymmetric:
        raise NotImplementedError(
            "the azimuth stage of the volume seed (geodesic_position_azm) "
            "is not ported yet: it comes with the slice that ports the "
            "analytic azimuth and time-delay integrals; pass "
            "axisymmetric=True for a source that does not depend on phi")
    g, ok, P0s, r0, m0 = _volume_seed_geom(a, incl, npix, rmax, r_start,
                                           dtype, default_device(device))
    phi0 = torch.zeros_like(r0)
    return _volume_seed_pack(g, ok, P0s, r0, m0, phi0, a, t0, r_start,
                             precision)


def _volume_march_loop(st, ok, r_start, emissivity_fn, max_steps,
                       absorption_fn=None):
    """Torch-loop march with transfer accumulation (any dtype, any
    callable); the counterpart of the JAX package's `_volume_march_xla`.

    Backward march (observer -> source): the carried optical depth tau is
    the attenuation between the current point and the observer, so
    I += j e^{-tau} s_eff with the exact piecewise-constant segment weight
    s_eff = (1 - e^{-alpha dl})/alpha (-> dl in the optically-thin limit).
    The tiny guard is the dtype's smallest normal: the JAX package's 1e-300
    flushes to 0 in f32.
    """
    r_min = 1.05 * r_bh(st.a.reshape(-1)[0])
    tiny = torch.finfo(st.x.dtype).tiny
    I = torch.zeros(ok.shape, dtype=st.x.dtype, device=st.x.device)
    tau = torch.zeros_like(I)
    active = ok
    it = 0
    while it < max_steps and bool(active.any()):
        st, dl = raytrace_step(st, active=active)
        t, r, m, phi = st.x.unbind(-1)
        j = emissivity_fn(t, r, m, phi)
        if absorption_fn is not None:
            al = absorption_fn(t, r, m, phi)
            dtau = al * dl
            seff = torch.where(dtau > 1e-10,
                               -torch.expm1(-dtau) / torch.clamp(al, min=tiny),
                               dl)
            I = I + torch.where(active, j * torch.exp(-tau) * seff, 0.0)
            tau = tau + torch.where(active, dtau, 0.0)
        else:
            I = I + torch.where(active, j * dl, 0.0)
        active = (active & (r > r_min) & (r < r_start * 1.2)
                  & (st.error < 1e-2) & torch.isfinite(r))
        it += 1
    return I


def _as_f32(st):
    """The march state in f32, as the JAX kernel path casts it."""
    return st._replace(**{f.name: getattr(st, f.name).float()
                          for f in dataclasses.fields(st)
                          if isinstance(getattr(st, f.name), torch.Tensor)
                          and getattr(st, f.name).is_floating_point()})


def volume_image(a, incl, emissivity_fn, npix=128, rmax=25.0,
                 r_start=60.0, max_steps=4000, precision=0.03,
                 engine="loop", t0=0.0, absorption_fn=None,
                 axisymmetric=False, dtype=torch.float64, device=None):
    """Image of a 3-D emissivity field: each pixel's ray is seeded exactly
    on its analytic geodesic at r = r_start and marched inward,
    accumulating I = int j(t, r, m, phi) e^{-tau} dl.

    `emissivity_fn(t, r, m, phi)` -> emissivity; rays start at t = t0 and t
    decreases along the (backward) march, so time-dependent sources see
    retarded time.  `absorption_fn(t, r, m, phi)` -> alpha (optional)
    switches on optically thick transfer, tau = int alpha dl toward the
    observer.

    engine="loop" marches with the torch step loop in `dtype` and takes any
    callables; engine="kernel" marches with the f32 march kernel and takes
    `GaussianSource` models only: the seed runs in `dtype`, then the state
    is cast to f32 for the kernel, as the JAX package's "pallas" engine
    does.  `axisymmetric=True` declares the source independent of phi and
    starts every ray at phi = 0; the azimuth stage that
    `axisymmetric=False` needs is not ported yet (NotImplementedError).
    `device=None` means the card.  Returns I, (npix, npix), 0 on pixels
    without a valid seed.
    """
    if engine not in ("loop", "kernel"):
        raise ValueError(f"engine {engine!r}: 'loop' or 'kernel'")
    st, ok = _volume_seed(a, incl, t0, npix, rmax, r_start, precision,
                          axisymmetric=axisymmetric, dtype=dtype,
                          device=device)
    if engine == "kernel":
        _, _, I = raytrace_kernel(
            _as_f32(st), r_max=r_start * 1.2, max_steps=max_steps,
            error_stop=1e-2, emissivity=emissivity_fn,
            absorption=absorption_fn, active0=ok)
        return torch.where(ok, I, 0.0)
    return _volume_march_loop(st, ok, r_start, emissivity_fn, max_steps,
                              absorption_fn=absorption_fn)


def volume_lightcurve(a, incl, emissivity_fn_t, t_obs, **kw):
    """Light curve of a time-dependent source: one `volume_image` per
    observer time t0, with the source evaluated at the ray-local (retarded)
    coordinate time.  Returns the total flux per time as a numpy array."""
    return np.asarray([float(volume_image(a, incl, emissivity_fn_t,
                                          t0=float(t), **kw).sum())
                       for t in np.asarray(t_obs)])

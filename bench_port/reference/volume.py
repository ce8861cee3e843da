"""The plain volume image of an orbiting spot on a sample of pixels.

The port's plain seed (`_volume_seed_geom`, `_volume_seed_azm`,
`_volume_seed_rays`, then `raytrace_prepare`) on the sampled pixels'
impact parameters, and its torch-loop march with the transfer step
(`_transfer_step`, `_volume_march_loop`), with the `GaussianSource`
formula as the emissivity.  Copies, in any dtype: the seed and the march
each take their own.
"""

import dataclasses
import math

import torch

from .core import r_bh
from .geodesic import (geodesic_init_inf, geodesic_P_int,
                        geodesic_position_rad, geodesic_position_pol,
                        geodesic_position_azm, geodesic_momentum)
from .march import raytrace_prepare, raytrace_step
from .nt_image import image_grid


def gaussian_source(amp=1.0, center=0.0, inv_width=0.0, inv_height=0.0,
                    cylindrical=False, t_center=0.0, inv_duration=0.0,
                    phi_center=0.0, omega=0.0, inv_arc=0.0):
    """j(t, r, m, phi) of the port's `GaussianSource` with these
    parameters: amp exp(-[((rho - center) inv_width)^2 + (z inv_height)^2
    + ((t - t_center) inv_duration)^2 + (rho dphi inv_arc)^2] / 2), z = r m,
    rho the cylindrical radius when `cylindrical`, dphi = phi - phi_center
    - omega t wrapped into [-pi, pi)."""
    def j(t, r, m, phi):
        rho = (r * torch.sqrt(torch.clamp(1.0 - m * m, min=0.0))
               if cylindrical else r)
        d = (rho - center) * inv_width
        z = r * m * inv_height
        w = (t - t_center) * inv_duration
        s = d * d + z * z + w * w
        if inv_arc != 0.0:
            dphi = torch.remainder(phi - phi_center - omega * t + math.pi,
                                   2.0 * math.pi) - math.pi
            e = rho * dphi * inv_arc
            s = s + e * e
        return amp * torch.exp(-0.5 * s)
    return j


def seed(a, incl, t0, alpha, beta, r_start, precision, dtype):
    """(march state, valid mask) of the rays through impact parameters
    (alpha, beta) (1-D, on the device), seeded on their analytic geodesics
    at r = r_start in `dtype`, with the azimuth stage."""
    alpha, beta = alpha.to(dtype), beta.to(dtype)
    g = geodesic_init_inf(incl, a, alpha, beta)
    ok = g.status == 0
    P0 = geodesic_P_int(g, torch.full(alpha.shape, r_start, dtype=dtype,
                                      device=alpha.device), 0)
    ok = ok & torch.isfinite(P0)
    P0s = torch.where(ok, P0, 1e-3)
    r0 = geodesic_position_rad(g, P0s)
    m0 = geodesic_position_pol(g, P0s)
    phi0 = geodesic_position_azm(g, torch.where(ok, r0, 40.0),
                                 torch.where(ok, m0, 0.0), P0s).to(r0.dtype)
    ok = ok & torch.isfinite(r0) & torch.isfinite(m0) & torch.isfinite(phi0)
    r0 = torch.where(ok, r0, r_start)
    m0 = torch.where(ok, m0, 0.0)
    phi0 = torch.where(ok, phi0, 0.0)
    k = geodesic_momentum(g, P0s, r0, m0)
    # k[2] of geodesic_momentum is dm/dP-signed; the march carries
    # dtheta/dlambda
    k = torch.cat([k[..., :2], -k[..., 2:3], k[..., 3:]], -1)
    k = torch.where(ok[..., None], k, torch.stack(
        [torch.ones_like(r0), -torch.ones_like(r0), torch.zeros_like(r0),
         torch.zeros_like(r0)], -1))
    x0 = torch.stack([torch.full_like(r0, t0), r0, m0, phi0], -1)
    return raytrace_prepare(a, x0, k, precision=precision), ok


def _cast(st, dtype):
    return st._replace(**{f.name: getattr(st, f.name).to(dtype)
                          for f in dataclasses.fields(st)
                          if isinstance(getattr(st, f.name), torch.Tensor)
                          and getattr(st, f.name).is_floating_point()})


def march(st, ok, r_start, emissivity, max_steps):
    """The optically thin transfer march of the torch loop: I = int j dl
    along each ray's backward march, in the state's dtype; stops when no
    ray is active (one `.any()` a step) or after max_steps steps."""
    r_min = 1.05 * r_bh(st.a.reshape(-1)[0])
    r_max = r_start * 1.2
    I = torch.zeros(ok.shape, dtype=st.x.dtype, device=st.x.device)
    active = ok
    it = 0
    while it < max_steps and bool(active.any()):
        st, dl = raytrace_step(st, active=active)
        t, r, m, phi = st.x.unbind(-1)
        I = I + torch.where(active, emissivity(t, r, m, phi) * dl, 0.0)
        active = (active & (r > r_min) & (r < r_max) & (st.error < 1e-2)
                  & torch.isfinite(r))
        it += 1
    return I


def pixels_image(a, incl, t0, npix, rmax, r_start, max_steps, precision,
                 source, index, seed_dtype, march_dtype, device, block=8192):
    """I at the flat pixel indices `index` of the npix^2 image: each
    sampled pixel's ray seeded in `seed_dtype` and marched in
    `march_dtype`, in blocks of `block` rays; 0 where the seed is not
    valid.  Returns (len(index),) f64 on the CPU."""
    alpha, beta = image_grid(npix, npix, rmax, torch.float64, device)
    alpha, beta = alpha.reshape(-1), beta.reshape(-1)
    index = torch.as_tensor(index, device=device)
    out = []
    with torch.no_grad():
        for s in range(0, index.numel(), block):
            idx = index[s:s + block]
            st, ok = seed(a, incl, t0, alpha[idx], beta[idx], r_start,
                          precision, seed_dtype)
            I = march(_cast(st, march_dtype), ok, r_start, source, max_steps)
            out.append(torch.where(ok, I, 0.0).double().cpu())
    return torch.cat(out)

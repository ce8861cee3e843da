"""The plain hot-spot light curve: every pixel's equatorial crossing map,
then the spot's flux over it.

Copies of the port's `_crossing_map_unanchored`,
`equatorial_crossing_map_reference`'s anchor, `spot_flux` and
`hotspot_lightcurve`'s sum over the image orders, in any dtype, the map
computed in blocks of rows so that a large image fits.
"""

import math

import torch

from .core import gfactorK, OmegaK, r_ms
from .geodesic import (geodesic_init_inf, geodesic_find_midplane_crossing,
                        geodesic_P_int, geodesic_position_rad,
                        geodesic_position_pol, geodesic_position_azm,
                        geodesic_timedelay_full)
from .nt_image import image_grid

R_FAR = 1e4   # the far-field sphere the delays are anchored at


def crossing_rows(a, incl, alpha, beta, order):
    """One order's crossing map of the pixels (alpha, beta): a dict of r,
    phi, g, dt (the delay before its anchoring) and hit, in alpha's
    dtype."""
    dtype = alpha.dtype
    g = geodesic_init_inf(incl, a, alpha, beta)
    P = geodesic_find_midplane_crossing(g, order)
    r = geodesic_position_rad(g, P)
    hit = torch.isfinite(r) & (g.status == 0)
    r_s = torch.where(hit, r, 10.0)
    m0 = torch.zeros_like(r_s)
    phi = geodesic_position_azm(g, r_s, m0, torch.where(hit, P, 1.0))
    gf = gfactorK(r_s, a, g.l)
    hit = hit & torch.isfinite(gf) & (r_s > r_ms(torch.as_tensor(
        a, dtype=dtype, device=alpha.device)))
    gf = torch.where(hit, gf, 1.0)
    phi = torch.where(hit & torch.isfinite(phi), phi, 0.0)
    # travel time to the crossing, anchored at the sphere r = R_FAR plus
    # the plane-wavefront correction b^2 / (2 R_FAR)
    P_far = geodesic_P_int(g, torch.full_like(r_s, R_FAR), 0)
    P_far = torch.where(torch.isfinite(P_far), P_far, 1e-4)
    r_far = geodesic_position_rad(g, P_far)
    m_far = geodesic_position_pol(g, P_far)
    dt = geodesic_timedelay_full(g, torch.where(hit, P, 1.0), r_s, m0,
                                 P_far, r_far, m_far)
    dt = dt + (alpha ** 2 + beta ** 2) / (2.0 * R_FAR)
    dt = torch.where(hit & torch.isfinite(dt), dt, 0.0)
    return dict(r=r_s, phi=phi, g=gf, dt=dt, hit=hit)


def crossing_map(a, incl, npix, rmax, order, dtype, device, rows=64):
    """One order's anchored crossing map at npix^2 in `dtype`, computed
    `rows` image rows at a time: a dict of (npix, npix) r, phi, g, delay,
    hit."""
    alpha, beta = image_grid(npix, npix, rmax, dtype, device)
    parts = [crossing_rows(a, incl, alpha[s:s + rows], beta[s:s + rows],
                           order) for s in range(0, npix, rows)]
    m = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    hit, dt = m["hit"], m["dt"]
    delay = dt - torch.min(torch.where(hit, dt, math.inf))
    return dict(r=m["r"], phi=m["phi"], g=m["g"], delay=delay, hit=hit)


def spot_flux(m, Om, r_spot, spot_size, t, pixel_area):
    """The spot's flux over one map at observer times t (n_t,)."""
    phi_spot = Om * (t[:, None, None] - m["delay"])
    dphi = torch.remainder(m["phi"] - phi_spot + math.pi,
                           2.0 * math.pi) - math.pi
    d2 = (m["r"] - r_spot) ** 2 + (m["r"] * dphi) ** 2
    I_loc = torch.exp(-0.5 * d2 / spot_size ** 2)
    return torch.sum(torch.where(m["hit"], I_loc * m["g"] ** 4, 0.0)
                     * pixel_area, dim=(-2, -1))


def lightcurve(a, incl, r_spot, spot_size, t_obs, npix, rmax, n_orders,
               dtype, device, rows=64):
    """The light curve at times t_obs (a sequence of floats): the sum over
    the image orders of the spot's flux over each order's map, in `dtype`.
    Returns (n_t,) f64 on the CPU."""
    with torch.no_grad():
        Om = OmegaK(torch.as_tensor(r_spot, dtype=dtype, device=device), a)
        t = torch.as_tensor(t_obs, dtype=torch.float64).to(dtype=dtype,
                                                           device=device)
        total = torch.zeros_like(t)
        area = (2.0 * rmax / npix) ** 2
        for order in range(n_orders):
            m = crossing_map(a, incl, npix, rmax, order, dtype, device, rows)
            # the flux in blocks of rows too: (n_t, rows, npix) at a time
            for s in range(0, npix, rows):
                part = {k: v[s:s + rows] for k, v in m.items()}
                total = total + spot_flux(part, Om, r_spot, spot_size, t,
                                          area)
        return total.double().cpu()

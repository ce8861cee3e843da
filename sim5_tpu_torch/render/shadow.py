"""Black-hole shadow / horizon-scale imaging.

Port of `sim5_tpu/render/shadow.py`.  Renders the full equatorial plane
down to the horizon: the Keplerian disk outside the ISCO, the Cunningham
(1975) plunging flow inside it (conserved ISCO energy and angular
momentum, radial infall from normalization), and the captured-ray
silhouette (the shadow).  Beyond the reference, whose analytic engine
leaves the plunging trajectory types NaN (sim5kerr-geod.c:322-352).

Eager f64 torch on the device of the pixel grid (the card unless the
caller asks for the CPU); every masked branch keeps the JAX package's
NaN-safe dummy.
"""

import dataclasses

import torch

from ..core import (kerr_metric_contravariant, photon_momentum, r_bh, r_ms,
                    gfactorK, keplerian_EL)
from ..core.metric import default_device
from ..disk import nt_flux
from ..geodesic import (geodesic_init_inf, geodesic_find_midplane_crossing,
                        geodesic_position_rad, geodesic_is_captured)
from .image import image_grid


@dataclasses.dataclass(frozen=True)
class BHImage:
    """The maps of `render_bh_image`; the fields and their order are those
    of the JAX package's `BHImage`."""
    captured: torch.Tensor   # bool: ray falls into the hole (silhouette)
    hit: torch.Tensor        # bool: midplane emission above the horizon
    r: torch.Tensor          # emission radius (NaN where no hit)
    g: torch.Tensor          # redshift factor (0 where no hit)
    flux: torch.Tensor       # observed flux F*g^4 (0 where no hit)


def gfactor_plunge(r, a, k):
    """Redshift factor for emission from the plunging flow inside the
    ISCO: gas on the Cunningham (1975) trajectory that left the circular
    ISCO orbit conserving its E and L, with u_r < 0 from normalization.

    `k` is the contravariant photon 4-momentum (E_photon = -k_t = 1), so
    g = 1 / (-k . u) = 1 / (E k^t - u_r k^r - L k^phi); u_theta = 0 makes
    the k[2] sign convention irrelevant here.
    """
    E, L = keplerian_EL(r_ms(a), a)
    mc = kerr_metric_contravariant(a, r, torch.zeros_like(r))
    u_r2 = (-1.0 - (mc.g00 * E * E - 2.0 * mc.g03 * E * L
                    + mc.g33 * L * L)) / mc.g11
    u_r = -torch.sqrt(torch.clamp(u_r2, min=0.0))
    return 1.0 / (E * k[..., 0] - u_r * k[..., 1] - L * k[..., 3])


def render_bh_image(a, incl, npix_x=512, npix_y=512, rmax=12.0, disk=None,
                    inner_emissivity=None, device=None):
    """Image the equatorial plane to the horizon plus the shadow mask.

    disk: optional NTDisk for the flux outside the ISCO (flux is zero
    there otherwise).  inner_emissivity: optional callable F(r) on tensors
    for the plunging region (e.g. a power law); the redshift map `g` is
    always filled.  The maps are f64 on `device`: by default the disk's,
    else the card.

    Returns a BHImage of (npix_y, npix_x) maps.
    """
    if device is None and disk is not None:
        device = disk.a.device
    alpha, beta = image_grid(npix_x, npix_y, rmax, dtype=torch.float64,
                             device=default_device(device))
    g = geodesic_init_inf(incl, a, alpha, beta)
    captured = geodesic_is_captured(g)

    rh = r_bh(g.a)
    rms = r_ms(g.a)
    P0 = geodesic_find_midplane_crossing(g, 0)
    r0 = geodesic_position_rad(g, P0)
    hit = torch.isfinite(r0) & (r0 > 1.01 * rh) & (g.status == 0)
    r_safe = torch.where(hit, r0, rms + 1.0)

    # the photon that reaches the observer leaves the crossing point moving
    # outward (dr > 0), which matters for the plunging emitter's u_r != 0
    one = torch.ones_like(r_safe)
    kph = photon_momentum(g.a, r_safe, torch.zeros_like(r_safe), g.l, g.q,
                          one, one)
    # lanes with R(r) < 0 are NaN: zero them before gfactor_plunge
    kph = torch.where(torch.isfinite(kph), kph, 0.0)
    inside = hit & (r0 < rms)
    gf_kep = gfactorK(torch.maximum(r_safe, rms), g.a, g.l)
    gf_plg = gfactor_plunge(torch.where(inside, r_safe, rms - 1e-3), g.a, kph)
    gf = torch.where(inside, gf_plg, gf_kep)
    gf = torch.where(hit, gf, 0.0)

    flux = torch.zeros_like(gf)
    if disk is not None:
        flux = torch.where(hit & ~inside, nt_flux(disk, r_safe), 0.0)
    if inner_emissivity is not None:
        flux = torch.where(inside, inner_emissivity(r_safe), flux)
    flux = flux * gf ** 4

    return BHImage(captured=captured, hit=hit,
                   r=torch.where(hit, r0, torch.nan), g=gf, flux=flux)

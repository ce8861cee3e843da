"""Relativistic line profiles and Cunningham transfer functions.

Port of `sim5_tpu/render/lineprofile.py`.  Derived products of the
equatorial crossing maps: the observed profile of an intrinsically narrow
emission line (e.g. Fe K-alpha) from a Keplerian disk, and the g-binned
transfer function T(g; r) of spectral-fitting pipelines.  Each is a
binned sum over the per-pixel (r, g) maps: `index_add_` into an f64
tensor, where the JAX package has `jax.ops.segment_sum`.  On the card
the sums are atomic, so their order (and the last bits) changes from run
to run.

Eager f64 torch on `device` (the card unless the caller asks for the
CPU).
"""

import torch

from ..core import gfactorK, r_ms
from ..core.metric import default_device
from ..geodesic import (geodesic_init_inf, geodesic_find_midplane_crossing,
                        geodesic_position_rad)
from .image import image_grid


def disk_g_map(a, incl, npix=256, rmax=None, r_in=None, r_out=None,
               order=0, device=None):
    """Per-pixel (r, g, hit) maps of an equatorial Keplerian disk annulus,
    and the pixel area dA (a Python float)."""
    dev = default_device(device)
    rms = r_ms(torch.as_tensor(a, dtype=torch.float64, device=dev))
    if r_in is None:
        r_in = rms
    if r_out is None:
        r_out = 400.0
    if rmax is None:
        rmax = min(float(r_out) * 1.1, 60.0)
    alpha, beta = image_grid(npix, npix, rmax, dtype=torch.float64,
                             device=dev)
    g = geodesic_init_inf(incl, a, alpha, beta)
    P = geodesic_find_midplane_crossing(g, order)
    r = geodesic_position_rad(g, P)
    hit = torch.isfinite(r) & (g.status == 0) & (r >= r_in) & (r <= r_out)
    r_s = torch.where(hit, r, 10.0)
    gf = gfactorK(r_s, a, g.l)
    hit = hit & torch.isfinite(gf) & (gf > 0.0)
    return r_s, torch.where(hit, gf, 1.0), hit, (2.0 * rmax / npix) ** 2


def _g_index(gf, g_lo, g_hi, g_bins):
    """The g-bin of each pixel: truncation toward zero, then the clip, as
    the JAX package's `.astype(int32)` and `jnp.clip`."""
    idx = ((gf - g_lo) / (g_hi - g_lo) * g_bins).to(torch.int32)
    return torch.clamp(idx, 0, g_bins - 1).to(torch.int64)


def line_profile(a, incl, emissivity_index=3.0, npix=256, r_in=None,
                 r_out=None, g_bins=200, g_range=(0.2, 1.4), orders=2,
                 device=None):
    """Observed profile of a narrow line from a Keplerian disk with
    emissivity ~ r^-q: photon flux per unit g, binned over the image.

    Returns (g_centers, profile), each (g_bins,) f64.  Includes Doppler
    boosting and gravitational redshift (the g^3 photon-flux boost) and
    lensing via image orders 0 .. orders - 1.
    """
    dev = default_device(device)
    g_lo, g_hi = g_range
    edges = torch.linspace(g_lo, g_hi, g_bins + 1, dtype=torch.float64,
                           device=dev)
    centers = 0.5 * (edges[1:] + edges[:-1])
    prof = torch.zeros(g_bins, dtype=torch.float64, device=dev)
    for order in range(orders):
        r, gf, hit, dA = disk_g_map(a, incl, npix, None, r_in, r_out, order,
                                    device=dev)
        w = torch.where(hit, r ** (-emissivity_index) * gf ** 3 * dA, 0.0)
        idx = _g_index(gf, g_lo, g_hi, g_bins)
        prof = prof + torch.zeros_like(prof).index_add_(
            0, idx.reshape(-1), w.reshape(-1))
    dg = (g_hi - g_lo) / g_bins
    return centers, prof / dg


def transfer_function(a, incl, r_edges, g_bins=64, g_range=(0.2, 1.4),
                      npix=384, device=None):
    """Cunningham-style transfer table T[r_bin, g_bin]: the solid-angle
    weight reaching the observer per (emission radius, redshift) cell.

    Line profiles and reverberation kernels for any radial emissivity
    follow by weighting this table.  Returns (len(r_edges) - 1, g_bins)
    f64.
    """
    dev = default_device(device)
    r_edges = torch.as_tensor(r_edges, dtype=torch.float64, device=dev)
    nr = r_edges.shape[0] - 1
    g_lo, g_hi = g_range
    r, gf, hit, dA = disk_g_map(a, incl, npix, None, float(r_edges[0]),
                                float(r_edges[-1]), device=dev)
    r_idx = torch.clamp(torch.searchsorted(r_edges, r) - 1, 0, nr - 1)
    flat = r_idx * g_bins + _g_index(gf, g_lo, g_hi, g_bins)
    w = hit.to(torch.float64) * dA   # dA where hit, else 0
    T = torch.zeros(nr * g_bins, dtype=torch.float64, device=dev).index_add_(
        0, flat.reshape(-1), w.reshape(-1))
    return T.reshape(nr, g_bins)

"""The plain NT disk image of a batch of frames, and its gradient.

A copy of the port's `render_disk_image_reference` (and `image_grid`)
whose frames are given as (n,) tensors of M, a, mdot, alpha and the
inclination: `nt_setup` runs here too, so the disk state is worked out
again from the inputs the benchmark hands both sides.
"""

import torch

from .core import gfactorK
from .disk import nt_flux, nt_setup
from .geodesic import (geodesic_init_inf, geodesic_find_midplane_crossing,
                        geodesic_position_rad)


def image_grid(npix_x, npix_y, rmax, dtype, device):
    """Impact-parameter grids (alpha, beta), each (npix_y, npix_x), pixel
    centres, [0, 0] at the image centre (disk-image.c:57-58)."""
    ix = (torch.arange(npix_x, dtype=dtype, device=device) + 0.5) / npix_x \
        - 0.5
    iy = (torch.arange(npix_y, dtype=dtype, device=device) + 0.5) / npix_y \
        - 0.5
    alpha = ix[None, :] * 2.0 * rmax
    beta = iy[:, None] * 2.0 * rmax * (npix_y / npix_x)
    return torch.broadcast_tensors(alpha, beta)


def render(disk, incl, npix):
    """(image_f, image_g) of the frames of `disk` (fields of shape (n,)),
    each (n, npix, npix), in the disk's dtype and on its device; incl (n,).
    The port's plain chain, frame scalars broadcast over the pixels."""
    def frames(v):
        return v.reshape(-1, 1, 1)

    disk = disk._replace(M=frames(disk.M), a=frames(disk.a),
                         mdot=frames(disk.mdot), rms=frames(disk.rms))
    incl = frames(incl)
    a = disk.a
    rms = disk.rms - 1e-3  # reference compares against r_ms(a), not rms+1e-3
    rmax = rms + 8.0
    alpha, beta = image_grid(npix, npix, rmax, dtype=a.dtype, device=a.device)
    g = geodesic_init_inf(incl, a, alpha, beta)

    def shade(order):
        P = geodesic_find_midplane_crossing(g, order)
        r = geodesic_position_rad(g, P)
        hit = torch.isfinite(r) & (r >= rms) & (g.status == 0)
        r_safe = torch.where(hit, r, rms + 1.0)
        gf = gfactorK(r_safe, a, g.l)
        f = nt_flux(disk, r_safe)
        gf2 = gf * gf
        return (torch.isfinite(P), hit, torch.where(hit, f * (gf2 * gf2), 0.0),
                torch.where(hit, gf, 0.0))

    # disk-image.c:73-104: no order-0 crossing leaves the pixel dark; the
    # order-1 image is consulted only where order 0 crossed inside the ISCO
    has0, hit0, f0, g0 = shade(0)
    _, hit1, f1, g1 = shade(1)
    use1 = has0 & ~hit0
    image_f = torch.where(hit0, f0, torch.where(use1, f1, 0.0))
    image_g = torch.where(hit0, g0, torch.where(use1, g1, 0.0))
    return image_f, image_g


def frames_image(M, a, mdot, alpha, incl, npix, dtype, device):
    """The images of frames given by Python floats or (n,) lists of M, a,
    mdot, alpha and incl [rad], computed in `dtype` on `device`, one frame
    at a time: (f, g), each (n, npix, npix)."""
    def col(v, n):
        return torch.as_tensor(v, dtype=torch.float64).broadcast_to(n)

    n = len(a)
    cols = [col(v, (n,)) for v in (M, a, mdot, alpha, incl)]
    out_f, out_g = [], []
    with torch.no_grad():
        for k in range(n):
            m_, a_, md, al, inc = (c[k:k + 1].to(dtype=dtype, device=device)
                                   for c in cols)
            f, g = render(nt_setup(m_, a_, md, al), inc, npix)
            out_f.append(f[0])
            out_g.append(g[0])
    return torch.stack(out_f), torch.stack(out_g)


def frame_grad(M, a, mdot, alpha, incl, npix, scale, dtype, device):
    """The value scale * image_f.sum() of one frame and its gradient in (a,
    incl, mdot), by autograd through the plain chain in `dtype`: ((value,
    d/da, d/dincl, d/dmdot) as Python floats)."""
    def leaf(v):
        return torch.tensor([float(v)], dtype=torch.float64).to(
            dtype=dtype, device=device).requires_grad_(True)

    a_, inc, md = leaf(a), leaf(incl), leaf(mdot)
    m_, al = (torch.tensor([float(v)], dtype=torch.float64).to(
        dtype=dtype, device=device) for v in (M, alpha))
    f, _ = render(nt_setup(m_, a_, md, al), inc, npix)
    loss = f.sum() * scale
    grads = torch.autograd.grad(loss, (a_, inc, md))
    return (float(loss.detach()), *(float(g) for g in grads))

"""Equatorial-disk image rendering (the example-04 pipeline, batched), and
the observer's pixel grid.

Port of `sim5_tpu/render/image.py`.  Every pixel's geodesic is
initialised, intersected with the equatorial plane (orders 0 and 1, the
direct and the first orbiting image) and shaded by the NT flux and the
Keplerian g-factor.  `render_disk_image` runs one launch of the CUDA
kernel `csrc/disk_image.cu` for a disk on the card, and its plain torch
version `render_disk_image_reference` for a disk on the CPU.  A disk of
(n,) tensors (`nt_setup` over n spins) renders n frames at once, the
port's form of `jax.vmap` over the JAX package's `render_disk_image`.
Both are differentiable in (M, a, mdot, incl, rmax): on the card through
the tangent kernel (backward and forward mode), on the CPU by autograd.
"""

import torch

from ..core import gfactorK
from ..core.metric import default_device
from ..disk import NTDisk, nt_flux
from ..geodesic import (geodesic_init_inf, geodesic_find_midplane_crossing,
                        geodesic_position_rad)
from .kernel_image import batch_shape, render_disk_image_cuda, row_window


def image_grid(npix_x, npix_y, rmax, dtype=torch.float64, device=None):
    """Impact-parameter grids matching the reference example
    (disk-image.c:57-58): pixel centers, [0,0] at image center.  Returns
    (alpha, beta), each (npix_y, npix_x), on `device` (the card unless the
    caller asks for the CPU)."""
    dev = default_device(device)
    ix = (torch.arange(npix_x, dtype=dtype, device=dev) + 0.5) / npix_x - 0.5
    iy = (torch.arange(npix_y, dtype=dtype, device=dev) + 0.5) / npix_y - 0.5
    alpha = ix[None, :] * 2.0 * rmax
    beta = iy[:, None] * 2.0 * rmax * (npix_y / npix_x)
    return torch.broadcast_tensors(alpha, beta)


def render_disk_image_reference(disk: NTDisk, incl, npix_x=512, npix_y=512,
                                rmax=None, row0=0, rows=None):
    """The plain torch version of `render_disk_image`, on the disk's device
    and in its dtype, for one frame or a batch (`kernel_image.batch_shape`);
    differentiable (every masked branch keeps its NaN-safe dummy).  Rows
    [row0, row0 + rows) of the frame (rows None: the rest of it): the
    whole frame's grid is built and its rows sliced before the chain
    runs."""
    row0, rows = row_window(npix_y, row0, rows)
    shape = batch_shape(disk, incl, rmax)
    incl = torch.as_tensor(incl, dtype=disk.a.dtype, device=disk.a.device)
    if shape:
        # one frame a row: each frame's scalars broadcast over its pixels
        def frames(v):
            return v.broadcast_to(shape).reshape(tuple(shape) + (1, 1))

        disk = disk._replace(M=frames(disk.M), a=frames(disk.a),
                             mdot=frames(disk.mdot), rms=frames(disk.rms))
        incl = frames(incl)
        if isinstance(rmax, torch.Tensor):
            rmax = frames(rmax.to(dtype=disk.a.dtype, device=disk.a.device))
    a = disk.a
    rms = disk.rms - 1e-3  # reference compares against r_ms(a), not rms+1e-3
    if rmax is None:
        rmax = rms + 8.0
    alpha, beta = image_grid(npix_x, npix_y, rmax, dtype=a.dtype,
                             device=a.device)
    if (row0, rows) != (0, npix_y):
        alpha = alpha[..., row0:row0 + rows, :]
        beta = beta[..., row0:row0 + rows, :]

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

    # reference control flow (disk-image.c:73-104): if the order-0 crossing
    # does not exist the pixel stays dark; the order-1 (bottom) image is
    # only consulted when order 0 crossed inside the ISCO
    has0, hit0, f0, g0 = shade(0)
    _, hit1, f1, g1 = shade(1)
    use1 = has0 & ~hit0
    image_f = torch.where(hit0, f0, torch.where(use1, f1, 0.0))
    image_g = torch.where(hit0, g0, torch.where(use1, g1, 0.0))
    return image_f, image_g


def render_disk_image(disk: NTDisk, incl, npix_x=512, npix_y=512, rmax=None,
                      row0=0, rows=None):
    """Render flux and g-factor images of an equatorial NT disk.

    Args:
      disk: NTDisk (`nt_setup`); its device and dtype (f64 parity or f32
        fast path) are the image's.  Fields of shape (n,) (`nt_setup` over
        n spins) are n frames.
      incl: observer inclination [rad], a scalar or one value a frame.
      npix_x, npix_y: image dimensions.
      rmax: half-width of the field of view [rg], a scalar or one value a
        frame; default rms + 8 (reference example default,
        disk-image.c:42).
      row0, rows: render only rows [row0, row0 + rows) of the frame (rows
        None: the rest of it), each pixel as in the whole frame; a rank of
        `parallel.render_disk_image_sharded` renders its rows so.

    Returns:
      (image_f, image_g): (rows, npix_x) tensors for one frame, (n, rows,
      npix_x) for n (rows = npix_y by default); image_f = F * g^4 [erg
      cm-2 s-1], image_g = g-factor (0 where the ray misses the disk).

    A disk on the card renders in one launch of the CUDA kernel, all its
    frames at once, whether or not an input requires grad
    (`kernel_image.render_disk_image_cuda`); its gradients, backward and
    forward mode, come from the tangent kernel (`kernel_image._NTImage`).
    A disk on the CPU takes the plain torch version, which autograd
    differentiates through the special functions' derivative rules.
    """
    dev = disk.a.device
    if dev.type == "cuda":
        return render_disk_image_cuda(disk, incl, npix_x, npix_y, rmax,
                                      row0, rows)
    if dev.type == "cpu":
        return render_disk_image_reference(disk, incl, npix_x, npix_y, rmax,
                                           row0, rows)
    raise ValueError(f"no disk image for device {dev}")

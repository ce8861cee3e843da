"""The observer's pixel grid.

Port of `sim5_tpu/render/image.py` (`image_grid`; the disk image itself
waits for the slice that ports the disk).
"""

import torch

from ..core.metric import default_device


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

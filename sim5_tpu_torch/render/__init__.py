"""Renderers: the observer's pixel grid, the Novikov-Thorne disk image
and volume radiative transfer.

Port of `sim5_tpu/render` (the disk image and the volume path so far).
"""

from .image import image_grid, render_disk_image, render_disk_image_reference
from .lightcurve import volume_image, volume_lightcurve

"""Renderers: the observer's pixel grid, the Novikov-Thorne disk image,
volume radiative transfer and the hot-spot light curve.

Port of `sim5_tpu/render` (the disk image, the volume path and the
light curves so far).
"""

from .image import image_grid, render_disk_image, render_disk_image_reference
from .lightcurve import (equatorial_crossing_map, hotspot_lightcurve,
                         volume_image, volume_lightcurve)

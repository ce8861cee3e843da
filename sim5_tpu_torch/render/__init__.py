"""Renderers: the observer's pixel grid and volume radiative transfer.

Port of `sim5_tpu/render` (the volume path so far).
"""

from .image import image_grid
from .lightcurve import volume_image, volume_lightcurve

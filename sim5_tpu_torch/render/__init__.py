"""Renderers: the observer's pixel grid, the Novikov-Thorne disk image,
the black-hole shadow, polarized images and spectra, line profiles and
transfer functions, volume radiative transfer and the hot-spot light
curve.

Port of `sim5_tpu/render` (the thick-disk driver `DiskRaytrace`, the
spectrum fit and the checkpoints wait for later slices).
"""

from .image import image_grid, render_disk_image, render_disk_image_reference
from .driver import (
    DiskSpectrum, DiskSpectrum_BlackBody,
    disk_tetrad, observed_gfactor, emission_angle,
    vertical_gravity, spectral_hardening,
)
from .polarized import (render_polarized_image, chandrasekhar_poldeg,
                        polarized_spectrum)
from .lightcurve import (equatorial_crossing_map, hotspot_lightcurve,
                         volume_image, volume_lightcurve)
from .lineprofile import disk_g_map, line_profile, transfer_function
from .shadow import BHImage, gfactor_plunge, render_bh_image

"""Renderers: the observer's pixel grid, the Novikov-Thorne disk image,
the disk raytracing driver (thick-disk surface solves, `DiskRaytrace`
images and spectra) and the differentiable spectrum fit, the black-hole
shadow, polarized images and spectra, line profiles and transfer
functions, volume radiative transfer, the hot-spot light curve and
resumable frame checkpoints.

Port of `sim5_tpu/render`.
"""

from .image import image_grid, render_disk_image, render_disk_image_reference
from .driver import (
    DiskSpectrum, DiskSpectrum_BlackBody,
    disk_tetrad, observed_gfactor, emission_angle,
    vertical_gravity, spectral_hardening,
    find_surface, find_surface_march, DiskRaytrace,
)
from .spectrum_fit import PolarGrid, make_polar_grid, disk_spectrum
from .polarized import (render_polarized_image, chandrasekhar_poldeg,
                        polarized_spectrum)
from .lightcurve import (equatorial_crossing_map, hotspot_lightcurve,
                         volume_image, volume_lightcurve)
from .checkpoint import (FrameCheckpoint, checkpointed_frames,
                         hotspot_lightcurve_checkpointed)
from .lineprofile import disk_g_map, line_profile, transfer_function
from .shadow import BHImage, gfactor_plunge, render_bh_image

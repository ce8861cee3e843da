"""Step-wise ray marching engine (batched adaptive RK4) and its kernel."""

from .raytrace import (
    RaytraceState, RTOPT_NONE, RTOPT_FLAT, RTOPT_POLARIZATION,
    raytrace_prepare, raytrace_step, raytrace, raytrace_error,
)
from .kernel_march import raytrace_kernel, raytrace_reference

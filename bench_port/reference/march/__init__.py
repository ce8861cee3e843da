"""The stepwise march (a copy of the port's `march/raytrace.py`)."""

from .raytrace import RaytraceState, raytrace_prepare, raytrace_step

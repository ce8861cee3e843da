"""Small math helpers (reference: sim5math.h/.c macros and routines).

Port of `sim5_tpu/utils/math.py`.  Dtype and device follow the inputs;
inputs that hold no tensor become f64 on the card (`core.metric`'s
`_as_tensors`).
"""

import math

import torch

from ..core.metric import _as_tensors


def sqr(x):
    return x * x


def sqr3(x):
    return x * x * x


def sqr4(x):
    x2 = x * x
    return x2 * x2


def sign(x):
    """sign(x) with sign(0) = +1 (reference macro semantics, sim5math.h:44)."""
    x, = _as_tensors(x)
    one = torch.ones_like(x)
    return torch.where(x >= 0.0, one, -one)


def deg2rad(x):
    x, = _as_tensors(x)
    return x * (math.pi / 180.0)


def rad2deg(x):
    x, = _as_tensors(x)
    return x * (180.0 / math.pi)


def reduce_angle_pi(x):
    """Reduce angle to [0, pi) (floor semantics, as jnp.mod).
    (sim5math.c:124-133)"""
    return torch.remainder(x, math.pi)


def reduce_angle_2pi(x):
    """Reduce angle to [0, 2 pi).  (sim5math.c:136-145)"""
    return torch.remainder(x, 2.0 * math.pi)


def ensure_range(x, lo, hi, acc):
    """Clamp x into [lo, hi]; the mask says where x was within `acc` of the
    range.  Returns (x_clamped, ok_mask).  (reference: ensure_range,
    sim5math.c)
    """
    x, = _as_tensors(x)
    ok = (x >= lo - acc) & (x <= hi + acc)
    return torch.clamp(x, lo, hi), ok


def sim5round(x):
    """Round to integer as ``(long)(num + 0.5)`` (reference: sim5round,
    sim5math.c:16): add 0.5, then truncate toward zero (-0.5 -> 0,
    -1.5 -> -1, -1.2 -> 0, as the C cast).
    """
    x, = _as_tensors(x)
    return torch.trunc(x + 0.5).to(torch.int64)


def cartesian_vector_to_spherical(x, y, z, Vx, Vy, Vz):
    """Cartesian vector [Vx, Vy, Vz] at point [x, y, z] -> spherical-basis
    components (V_r, V_theta, V_phi).  (reference: cartesian2spherical1,
    sim5math.c:150-163)

    On the z-axis the azimuthal basis is degenerate; the phi = 0
    convention (cos_f = 1, sin_f = 0) keeps the result finite, as in the
    JAX package.
    """
    x, y, z, Vx, Vy, Vz = _as_tensors(x, y, z, Vx, Vy, Vz)
    r = torch.sqrt(x * x + y * y + z * z)
    cos_h = z / r
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    safe = torch.clamp(sin_h, min=1e-300)
    on_axis = sin_h < 1e-15
    cos_f = torch.where(on_axis, 1.0, x / r / safe)
    sin_f = torch.where(on_axis, 0.0, y / r / safe)
    return _vec_to_spherical_basis(cos_h, sin_h, sin_f, cos_f, Vx, Vy, Vz)


def cartesian_vector_to_spherical_at(cos_h, sin_f, cos_f, Vx, Vy, Vz):
    """Same transform with the point given as (cos theta, sin phi, cos phi).
    (reference: cartesian2spherical2, sim5math.c:165-176)
    """
    cos_h, sin_f, cos_f, Vx, Vy, Vz = _as_tensors(cos_h, sin_f, cos_f,
                                                  Vx, Vy, Vz)
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    return _vec_to_spherical_basis(cos_h, sin_h, sin_f, cos_f, Vx, Vy, Vz)


def _vec_to_spherical_basis(cos_h, sin_h, sin_f, cos_f, Vx, Vy, Vz):
    Vr = sin_h * cos_f * Vx + sin_h * sin_f * Vy + cos_h * Vz
    Vh = cos_h * cos_f * Vx + cos_h * sin_f * Vy - sin_h * Vz
    Vf = -sin_f * Vx + cos_f * Vy
    return Vr, Vh, Vf


def cartesian_to_spherical(x, y, z):
    """(x, y, z) -> (r, theta, phi).  (sim5math.c:150-163)"""
    x, y, z = _as_tensors(x, y, z)
    r = torch.sqrt(x * x + y * y + z * z)
    theta = torch.arccos(torch.clamp(z / torch.where(r > 0, r, 1.0),
                                     -1.0, 1.0))
    phi = torch.arctan2(y, x)
    return r, theta, phi


def spherical_to_cartesian(r, theta, phi):
    """(r, theta, phi) -> (x, y, z).  (sim5math.c:166-176)"""
    r, theta, phi = _as_tensors(r, theta, phi)
    s = torch.sin(theta)
    return r * s * torch.cos(phi), r * s * torch.sin(phi), r * torch.cos(theta)

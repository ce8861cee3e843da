"""The orbiting source of the march kernel's emission family
(`march.emission.GaussianSource` with phi_center, omega and inv_arc).

* The plain torch form against a numpy formula of the same Gaussian,
  across the wrap of dphi at +-pi (`hotspot_lightcurve`'s wrap);
* inv_arc = 0 gives bitwise the family's values without the arc term,
  in the plain form and in the kernel's own `gauss` (what keeps every
  torus image of the march kernel bitwise as it was);
* `gauss` from `csrc/march.cu` built for the host with g++ (its text,
  with `__device__` and `__forceinline__` defined away) against the
  plain form in f32.

Tolerances, and why:
* plain form (f64) against numpy: 1e-13 of the amplitude (the same
  formula; exp of a sum of squares, whose relative rounding grows with
  the exponent, so far from the spot it is not relative);
* the host build against the plain form (f32): relative
  4 * 2**-23 * (1 + s), s = -2 ln(j / amp) the exponent, i.e. 4 f32 ulps
  of the exponent: the same operations in the same order without FMA
  contraction, but torch's f32 kernels and libm round some of them
  differently by an ulp, and exp turns an ulp of s into s ulps of j;
* inv_arc = 0: bitwise.
"""

import ctypes
import math
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sim5_tpu_torch import _build
from sim5_tpu_torch.march.emission import GaussianSource

N = 4096
SPOT = GaussianSource(amp=1.3, center=7.0, inv_width=1 / 0.7,
                      inv_height=1 / 0.7, cylindrical=True, phi_center=0.4,
                      omega=0.05, inv_arc=1 / 0.7)


def _points(dtype, seed=3):
    """(t, r, m, phi) around the spot, phi over several turns so that
    dphi wraps at +-pi."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(-200.0, 50.0, N)
    r = rng.uniform(4.0, 10.0, N)
    m = rng.uniform(-0.3, 0.3, N)
    phi = rng.uniform(-3 * np.pi, 3 * np.pi, N)
    return [torch.tensor(v, dtype=dtype) for v in (t, r, m, phi)]


def test_plain_form_against_numpy():
    t, r, m, phi = _points(torch.float64)
    got = SPOT(t, r, m, phi).numpy()
    t, r, m, phi = (v.numpy() for v in (t, r, m, phi))
    rho = r * np.sqrt(1.0 - m * m)
    dphi = np.mod(phi - SPOT.phi_center - SPOT.omega * t + np.pi,
                  2 * np.pi) - np.pi
    d2 = ((rho - 7.0) ** 2 + (r * m) ** 2 + (rho * dphi) ** 2) / 0.7 ** 2
    want = 1.3 * np.exp(-0.5 * d2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * 1.3)
    # the spot is seen: some points near it, and both sides of the wrap
    assert want.max() > 0.5
    assert (dphi > 3.0).any() and (dphi < -3.0).any()


def test_wrap_is_periodic():
    """phi and phi + 2 pi k give the same emissivity; so do t and t + one
    orbital period with phi advanced by nothing."""
    t, r, m, phi = _points(torch.float64, seed=4)
    j = SPOT(t, r, m, phi)
    torch.testing.assert_close(SPOT(t, r, m, phi + 4 * math.pi), j,
                               rtol=0, atol=1e-12 * 1.3)
    T = 2 * math.pi / SPOT.omega
    torch.testing.assert_close(SPOT(t + T, r, m, phi), j, rtol=0,
                               atol=1e-10 * 1.3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_inv_arc_zero_is_bitwise_the_family(dtype):
    t, r, m, phi = _points(dtype)
    still = GaussianSource(amp=1.3, center=7.0, inv_width=1 / 0.7,
                           inv_height=1 / 0.7, cylindrical=True,
                           phi_center=0.4, omega=0.05)
    rho = r * torch.sqrt(torch.clamp(1.0 - m * m, min=0.0))
    d = (rho - 7.0) * (1 / 0.7)
    z = r * m * (1 / 0.7)
    w = (t - 0.0) * 0.0
    want = 1.3 * torch.exp(-0.5 * (d * d + z * z + w * w))
    assert torch.equal(still(t, r, m, phi), want)


HARNESS = r"""
#include <math.h>
#define __device__
#define __forceinline__ inline
{constants}
{struct}
{gauss}
// the family without the arc term, as the kernel evaluated it before
static float still(const Gauss& g, float t, float r, float m) {{
  const float rho = g.cyl ? r * sqrtf(fmaxf(1.0f - m * m, 0.0f)) : r;
  const float d = (rho - g.center) * g.inv_w;
  const float z = r * m * g.inv_h;
  const float w = (t - g.t_c) * g.inv_d;
  return g.amp * expf(-0.5f * (d * d + z * z + w * w));
}}
extern "C" void eval(const float* p, int cyl, const float* t, const float* r,
                     const float* m, const float* phi, long long n,
                     float* j, float* j_still) {{
  const Gauss g{{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], cyl}};
  for (long long i = 0; i < n; ++i) {{
    j[i] = gauss(g, t[i], r[i], m[i], phi[i]);
    j_still[i] = still(g, t[i], r[i], m[i]);
  }}
}}
"""


def _source_parts():
    """kPi, `struct Gauss` and `gauss` as they stand in csrc/march.cu."""
    text = (_build.CSRC / "march.cu").read_text()
    const = re.search(r"constexpr float kPi = [^;]+;", text)[0]
    struct = re.search(r"struct Gauss \{.*?\};", text, re.S)[0]
    gauss = re.search(r"__device__ __forceinline__ float gauss\(.*?\n\}\n",
                      text, re.S)[0]
    return const, struct, gauss


@pytest.fixture(scope="module")
def host_gauss(tmp_path_factory):
    """march.cu's `gauss` built with g++ (no FMA contraction), or a skip
    where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine: the host build of the device "
                    "function cannot be made")
    const, struct, gauss = _source_parts()
    tmp = tmp_path_factory.mktemp("gauss_host")
    src, lib = tmp / "gauss.cpp", tmp / "libgauss.so"
    src.write_text(HARNESS.format(constants=const, struct=struct,
                                  gauss=gauss))
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(lib), str(src)], capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    dll = ctypes.CDLL(str(lib))
    dll.eval.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                         + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                         + [ctypes.c_void_p] * 2)
    dll.eval.restype = None
    return dll


def _host(lib, src, pts):
    p = torch.tensor(src.params()[:9], dtype=torch.float32)
    j, j_still = torch.empty(N), torch.empty(N)
    lib.eval(p.data_ptr(), src.params()[9], *(v.data_ptr() for v in pts), N,
             j.data_ptr(), j_still.data_ptr())
    return j, j_still


def test_host_gauss_matches_plain_form(host_gauss):
    pts = _points(torch.float32)
    j, _ = _host(host_gauss, SPOT, pts)
    want = SPOT(*pts)
    assert float(want.max()) > 0.5
    expo = torch.clamp(-2.0 * torch.log(SPOT(*(v.double() for v in pts))
                                        / SPOT.amp), max=1e4)
    # (+ the smallest normal f32: below it the results are subnormal)
    bound = (4 * 2.0 ** -23 * (1.0 + expo) * want.double()
             + torch.finfo(torch.float32).tiny)
    assert bool(((j.double() - want.double()).abs() <= bound).all())


def test_host_gauss_inv_arc_zero_is_bitwise(host_gauss):
    still = GaussianSource(amp=1.3, center=7.0, inv_width=1 / 0.7,
                           inv_height=1 / 0.7, cylindrical=True,
                           phi_center=0.4, omega=0.05)
    j, j_still = _host(host_gauss, still, _points(torch.float32))
    assert torch.equal(j, j_still)

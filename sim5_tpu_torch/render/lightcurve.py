"""Time-dependent observables: orbiting hot-spot light curves, and
images and light curves of a 3-D source by volume radiative transfer.

Port of `sim5_tpu/render/lightcurve.py`.

* `hotspot_lightcurve` uses the analytic engine: every image-plane ray's
  equatorial crossing (radius, azimuth, g-factor, travel-time delay) is
  computed once (`equatorial_crossing_map`); a light curve for a spot
  trajectory is then a reduction over pixels.
* `volume_image` / `volume_lightcurve` (BASELINE config #4) use both
  engines: the analytic engine supplies exact initial conditions on a
  sphere r = r_start (position, azimuth and momentum of each pixel's
  geodesic), and the stepwise engine marches every ray inward,
  accumulating I = int j e^{-tau} dl with tau = int alpha dl toward the
  observer.

On the card the crossing maps and the seed are kernels, one pixel a
thread (`kernel_analytic`: `crossing_map<double>`, `volume_seed<T,
azm>`); on the CPU, and for inputs that require grad, their plain torch
chains (`_kernel_route`).

Three march engines:

* "loop" (the JAX package's "xla"): a torch loop over `raytrace_step` in
  any dtype, with any callable emissivity and absorption;
* "scan": the reverse-differentiable engine (`_volume_march_scan`), a
  fixed trip count of checkpointed segments of the same masked step, in
  eager torch (the JAX package's scan engine is XLA, not Pallas);
* "kernel" (the JAX package's "pallas"): the f32 march kernel with fused
  transfer (`march.kernel_march.raytrace_kernel`), which takes any
  emissivity and absorption of the elementwise ops of
  `march.model_trace.OPS` (traced into a build of the kernel for their
  structure; a `march.emission.GaussianSource` runs in the kernel's
  compiled-in family).  Forward only, as the JAX package's "pallas"
  engine: inputs that require grad raise.
"""

import dataclasses
import math

import numpy as np
import torch
import torch.utils.checkpoint

from ..core import gfactorK, OmegaK, r_bh, r_ms
from ..core.metric import default_device
from ..geodesic import (geodesic_init_inf, geodesic_find_midplane_crossing,
                        geodesic_P_int, geodesic_position_rad,
                        geodesic_position_pol, geodesic_position_azm,
                        geodesic_timedelay_full, geodesic_momentum)
from ..march import raytrace_prepare, raytrace_step, raytrace_kernel
from ..march.emission import prepare
from .image import image_grid

R_FAR = 1e4   # the far-field sphere the crossing map's delays are anchored at


def equatorial_crossing_map(a, incl, npix, rmax, order=0, device=None):
    """For every image-plane pixel, the equatorial crossing of `order`
    (0 the direct image, 1 the first orbiting one): a dict of (npix, npix)
    tensors r, phi, g (the Keplerian g-factor), delay (the relative time
    delay) and hit (the mask), and the scalar pixel_area.  `order` may be
    a sequence of orders, the order axis: the tensors are then (n_orders,
    npix, npix), each order's map that of its own call.

    phi follows geodesic_position_azm (angle change from infinity); delays
    are relative to the earliest-arriving hit pixel of their order.
    Crossings inside the marginally stable orbit, where there is no
    circular orbit, are no hit.  The map is f64, as the JAX function's;
    `device=None` means the card.

    On the card, with no input that requires grad, one launch of the
    crossing-map kernel computes every order (`kernel_analytic`); with an
    input that requires grad, and on the CPU, the plain torch chain
    (`_crossing_map_unanchored`) computes each order, under autograd: the
    kernel has no derivative.  Each order's map is, bitwise, that of
    `equatorial_crossing_map_reference`.
    """
    dev = default_device(device)
    single = np.ndim(order) == 0
    orders = (int(order),) if single else tuple(int(o) for o in order)
    if _kernel_route(dev, a, incl, rmax):
        from . import kernel_analytic
        m = kernel_analytic.crossing_maps(a, incl, npix, rmax, orders, dev)
    else:
        maps = [_crossing_map_unanchored(a, incl, npix, rmax, o, dev)
                for o in orders]
        m = {k: torch.stack([mo[k] for mo in maps]) for k in maps[0]}
    # the anchor: one masked reduction an order, outside the kernel, as the
    # JAX program computes it outside any Pallas kernel (the minimum is
    # exact: each order's bits are those of its own plain map)
    dt = m["dt"] - torch.amin(torch.where(m["hit"], m["dt"], math.inf),
                              dim=(-2, -1), keepdim=True)
    out = dict(r=m["r"], phi=m["phi"], g=m["g"], delay=dt, hit=m["hit"])
    if single:
        out = {k: v[0] for k, v in out.items()}
    out["pixel_area"] = (2.0 * rmax / npix) ** 2
    return out


def _crossing_map_unanchored(a, incl, npix, rmax, order=0, device=None):
    """The plain torch chain of one order's crossing map: a dict of
    (npix, npix) f64 tensors r, phi, g, dt (the delay before its
    anchoring) and hit; the crossing-map kernel's plain version."""
    alpha, beta = image_grid(npix, npix, rmax, dtype=torch.float64,
                             device=default_device(device))
    g = geodesic_init_inf(incl, a, alpha, beta)
    P = geodesic_find_midplane_crossing(g, order)
    r = geodesic_position_rad(g, P)
    hit = torch.isfinite(r) & (g.status == 0)
    r_s = torch.where(hit, r, 10.0)
    m0 = torch.zeros_like(r_s)
    phi = geodesic_position_azm(g, r_s, m0, torch.where(hit, P, 1.0))
    gf = gfactorK(r_s, a, g.l)
    hit = hit & torch.isfinite(gf) & (r_s > r_ms(torch.as_tensor(
        a, dtype=torch.float64, device=alpha.device)))
    gf = torch.where(hit, gf, 1.0)
    phi = torch.where(hit & torch.isfinite(phi), phi, 0.0)
    # Travel time to the crossing, anchored at a common far-field sphere
    # r = R_FAR plus the plane-wavefront correction: along an incoming ray
    # with impact parameter b, t(r) = r + 2 ln r + (4 + b^2/2 + ...)/r +
    # const, so relative to a plane wavefront the ray reaches R_FAR late by
    # b^2/(2 R_FAR).  The delay is the full time integral (radial +
    # poloidal); the reference disables the theta part
    # (sim5kerr-geod.c:663-702), which is wrong at high inclination.
    P_far = geodesic_P_int(g, torch.full_like(r_s, R_FAR), 0)
    P_far = torch.where(torch.isfinite(P_far), P_far, 1e-4)
    r_far = geodesic_position_rad(g, P_far)
    m_far = geodesic_position_pol(g, P_far)
    dt = geodesic_timedelay_full(g, torch.where(hit, P, 1.0), r_s, m0,
                                 P_far, r_far, m_far)
    dt = dt + (alpha ** 2 + beta ** 2) / (2.0 * R_FAR)
    dt = torch.where(hit & torch.isfinite(dt), dt, 0.0)
    return dict(r=r_s, phi=phi, g=gf, dt=dt, hit=hit)


def equatorial_crossing_map_reference(a, incl, npix, rmax, order=0,
                                      device=None):
    """The plain torch version of `equatorial_crossing_map` for one order,
    on `device` (the card unless the caller asks for the CPU),
    differentiable: the chain, then the anchor."""
    m = _crossing_map_unanchored(a, incl, npix, rmax, order, device)
    hit, dt = m["hit"], m["dt"]
    dt = dt - torch.min(torch.where(hit, dt, math.inf))
    return dict(r=m["r"], phi=m["phi"], g=m["g"], delay=dt, hit=hit,
                pixel_area=(2.0 * rmax / npix) ** 2)


def crossing_order(m, k):
    """Order k's map of an `equatorial_crossing_map` with the order axis."""
    return {key: v if key == "pixel_area" else v[k] for key, v in m.items()}


def hotspot_lightcurve(a, incl, r_spot, spot_size, t_obs, npix=256,
                       rmax=None, n_orders=2, device=None):
    """Bolometric light curve of a Gaussian hot spot on a circular
    Keplerian orbit at radius r_spot, with the Doppler and gravitational
    g-factor (g^4 boost), lensing (image orders 0 .. n_orders - 1) and
    time delays.

    t_obs: observer times [GM/c^3].  Returns the flux at each, (n_t,) f64
    (arbitrary units, normalized to spot intensity 1), on `device` (the
    card unless the caller asks for the CPU).  The crossing maps of all
    orders are one `equatorial_crossing_map` call (one kernel launch on
    the card).
    """
    if rmax is None:
        rmax = r_spot * 2.5
    dev = default_device(device)
    Om = OmegaK(torch.as_tensor(r_spot, dtype=torch.float64, device=dev), a)
    t = torch.as_tensor(np.asarray(t_obs, dtype=np.float64), device=dev)
    total = torch.zeros_like(t)
    maps = equatorial_crossing_map(a, incl, npix, rmax, range(n_orders),
                                   device=dev)
    for order in range(n_orders):
        total = total + spot_flux(crossing_order(maps, order), Om, r_spot,
                                  spot_size, t)
    return total


def spot_flux(m, Om, r_spot, spot_size, t):
    """The spot's flux over one crossing map `m` at observer times t (n_t,):
    one broadcast over a leading time axis."""
    # spot centre at the emission (retarded) time of each pixel
    phi_spot = Om * (t[:, None, None] - m["delay"])
    dphi = torch.remainder(m["phi"] - phi_spot + math.pi,
                           2.0 * math.pi) - math.pi
    # distance on the disk plane
    d2 = (m["r"] - r_spot) ** 2 + (m["r"] * dphi) ** 2
    I_loc = torch.exp(-0.5 * d2 / spot_size ** 2)
    return torch.sum(torch.where(m["hit"], I_loc * m["g"] ** 4, 0.0)
                     * m["pixel_area"], dim=(-2, -1))


def _volume_seed_geom(a, incl, npix, rmax, r_start, dtype, device):
    """Per-pixel analytic seed without the azimuth: (geodesic, valid mask,
    P, r, m) at r = r_start."""
    alpha, beta = image_grid(npix, npix, rmax, dtype=dtype, device=device)
    g = geodesic_init_inf(incl, a, alpha, beta)
    ok = g.status == 0
    P0 = geodesic_P_int(g, torch.full(alpha.shape, r_start, dtype=dtype,
                                      device=alpha.device), 0)
    ok = ok & torch.isfinite(P0)
    P0s = torch.where(ok, P0, 1e-3)
    r0 = geodesic_position_rad(g, P0s)
    m0 = geodesic_position_pol(g, P0s)
    return g, ok, P0s, r0, m0


def _volume_seed_azm(g, ok, P0s, r0, m0):
    """The azimuth stage of the seed: phi at r = r_start (f64 whatever the
    seed's dtype, see geodesic_position_azm), cast to the seed's dtype."""
    return geodesic_position_azm(g, torch.where(ok, r0, 40.0),
                                 torch.where(ok, m0, 0.0), P0s).to(r0.dtype)


def _volume_seed_rays(g, ok, P0s, r0, m0, phi0, t0, r_start):
    """The seeded rays (x0, k) and the valid mask: invalid pixels get a
    finite dummy ray that `ok` keeps inactive."""
    ok = ok & torch.isfinite(r0) & torch.isfinite(m0) & torch.isfinite(phi0)
    r0 = torch.where(ok, r0, r_start)
    m0 = torch.where(ok, m0, 0.0)
    phi0 = torch.where(ok, phi0, 0.0)
    k = geodesic_momentum(g, P0s, r0, m0)
    # marching convention: k[2] of geodesic_momentum is dm/dP-signed; the
    # integrator treats k^2 as dtheta/dlambda -> flip
    k = torch.cat([k[..., :2], -k[..., 2:3], k[..., 3:]], -1)
    k = torch.where(ok[..., None], k, torch.stack(
        [torch.ones_like(r0), -torch.ones_like(r0), torch.zeros_like(r0),
         torch.zeros_like(r0)], -1))
    x0 = torch.stack([torch.full_like(r0, t0), r0, m0, phi0], -1)
    return x0, k, ok


def _volume_seed_plain(a, incl, t0, npix, rmax, r_start, axisymmetric,
                       dtype, device):
    """The plain torch chain of the seed's rays: (x0, k, ok), as the
    volume-seed kernel writes them (its plain version)."""
    g, ok, P0s, r0, m0 = _volume_seed_geom(a, incl, npix, rmax, r_start,
                                           dtype, default_device(device))
    phi0 = (torch.zeros_like(r0) if axisymmetric
            else _volume_seed_azm(g, ok, P0s, r0, m0))
    return _volume_seed_rays(g, ok, P0s, r0, m0, phi0, t0, r_start)


def _volume_seed_reference(a, incl, t0, npix, rmax, r_start, precision,
                           axisymmetric=False, dtype=torch.float64,
                           device=None):
    """The plain torch version of `_volume_seed`, differentiable: the
    plain rays (geometry, azimuth, packing; axisymmetric=True starts every
    ray at phi = 0 and skips the azimuth, see volume_image), then
    raytrace_prepare."""
    x0, k, ok = _volume_seed_plain(a, incl, t0, npix, rmax, r_start,
                                   axisymmetric, dtype, device)
    return raytrace_prepare(a, x0, k, precision=precision), ok


def _volume_seed(a, incl, t0, npix, rmax, r_start, precision,
                 axisymmetric=False, dtype=torch.float64, device=None):
    """Seed every pixel's ray on its analytic geodesic at r = r_start:
    returns (march state, valid mask).  axisymmetric=True starts every ray
    at phi = 0 and computes no azimuth (see volume_image).

    On the card, with no input that requires grad, one launch of the
    volume-seed kernel writes the rays (`kernel_analytic`), and
    raytrace_prepare makes the state; with an input that requires grad
    (the scan engine's gradients), and on the CPU, the plain torch chain
    (`_volume_seed_reference`), under autograd: the kernel has no
    derivative."""
    dev = default_device(device)
    if not _kernel_route(dev, a, incl, t0, rmax, r_start):
        return _volume_seed_reference(a, incl, t0, npix, rmax, r_start,
                                      precision, axisymmetric=axisymmetric,
                                      dtype=dtype, device=dev)
    from . import kernel_analytic
    x0, k, ok = kernel_analytic.volume_seed_rays(
        a, incl, t0, npix, rmax, r_start, axisymmetric, dtype, dev)
    return raytrace_prepare(a, x0, k, precision=precision), ok


def _transfer_step(st, I, tau, active, emissivity_fn, absorption_fn, r_min,
                   r_max, tiny):
    """One masked march step with the transfer accumulation, shared by the
    loop and scan engines: returns (st, I, tau, active).

    Backward march (observer -> source): the carried optical depth tau is
    the attenuation between the current point and the observer, so
    I += j e^{-tau} s_eff with the exact piecewise-constant segment weight
    s_eff = (1 - e^{-alpha dl})/alpha (-> dl in the optically-thin limit).
    The tiny guard is the dtype's smallest normal: the JAX package's 1e-300
    flushes to 0 in f32.
    """
    st, dl = raytrace_step(st, active=active)
    t, r, m, phi = st.x.unbind(-1)
    j = emissivity_fn(t, r, m, phi)
    if absorption_fn is not None:
        al = absorption_fn(t, r, m, phi)
        dtau = al * dl
        seff = torch.where(dtau > 1e-10,
                           -torch.expm1(-dtau) / torch.clamp(al, min=tiny),
                           dl)
        I = I + torch.where(active, j * torch.exp(-tau) * seff, 0.0)
        tau = tau + torch.where(active, dtau, 0.0)
    else:
        I = I + torch.where(active, j * dl, 0.0)
    active = (active & (r > r_min) & (r < r_max) & (st.error < 1e-2)
              & torch.isfinite(r))
    return st, I, tau, active


def _volume_march_loop(st, ok, r_start, emissivity_fn, max_steps,
                       absorption_fn=None):
    """Torch-loop march with transfer accumulation (any dtype, any
    callable); the counterpart of the JAX package's `_volume_march_xla`.
    It stops when no ray is active (one `.any()` a step)."""
    r_min = 1.05 * r_bh(st.a.reshape(-1)[0])
    tiny = torch.finfo(st.x.dtype).tiny
    I = torch.zeros(ok.shape, dtype=st.x.dtype, device=st.x.device)
    tau = torch.zeros_like(I)
    active = ok
    it = 0
    while it < max_steps and bool(active.any()):
        st, I, tau, active = _transfer_step(st, I, tau, active, emissivity_fn,
                                            absorption_fn, r_min,
                                            r_start * 1.2, tiny)
        it += 1
    return I


def _volume_march_scan(st, ok, r_start, emissivity_fn, n_steps=1024,
                       absorption_fn=None, segment_len=64):
    """Reverse-differentiable march with transfer accumulation: a fixed trip
    count of n_steps // segment_len segments of `segment_len` steps, each
    segment under `torch.utils.checkpoint` (non-reentrant).  The backward
    pass keeps one march state a segment and recomputes a segment's steps
    when it reaches it, so d(image)/d(spin, source parameters) costs about
    twice the forward march instead of memory linear in n_steps.

    The same masked step and transfer weights as `_volume_march_loop`
    (`_transfer_step`), so the two agree wherever the loop ran its rays to
    the end; unlike the loop it pays every step (no early exit), as the JAX
    package's `_volume_march_scan` does.
    """
    r_min = 1.05 * r_bh(st.a.reshape(-1)[0])
    tiny = torch.finfo(st.x.dtype).tiny

    def segment(st, I, tau, active):
        for _ in range(segment_len):
            st, I, tau, active = _transfer_step(
                st, I, tau, active, emissivity_fn, absorption_fn, r_min,
                r_start * 1.2, tiny)
        return st, I, tau, active

    I = torch.zeros(ok.shape, dtype=st.x.dtype, device=st.x.device)
    carry = (st, I, torch.zeros_like(I), ok)
    for _ in range(max(1, n_steps // segment_len)):
        carry = torch.utils.checkpoint.checkpoint(segment, *carry,
                                                  use_reentrant=False)
    return carry[1]


def _requires_grad(*vals):
    """Whether a tensor among `vals`, or a tensor field of a dataclass among
    them, requires grad."""
    for v in vals:
        fields = ([getattr(v, f.name) for f in dataclasses.fields(v)]
                  if dataclasses.is_dataclass(v) else [v])
        if any(isinstance(t, torch.Tensor) and t.requires_grad
               for t in fields):
            return True
    return False


def _kernel_route(device, *vals):
    """Whether an analytic entry point (the crossing map, the seed) runs
    its kernel: on the card, with no input among `vals` that requires
    grad.  Otherwise it runs the plain torch chain, under autograd: the
    kernels have no derivative."""
    return device.type == "cuda" and not _requires_grad(*vals)


def _as_f32(st):
    """The march state in f32, as the JAX kernel path casts it."""
    return st._replace(**{f.name: getattr(st, f.name).float()
                          for f in dataclasses.fields(st)
                          if isinstance(getattr(st, f.name), torch.Tensor)
                          and getattr(st, f.name).is_floating_point()})


def volume_image(a, incl, emissivity_fn, npix=128, rmax=25.0,
                 r_start=60.0, max_steps=4000, precision=0.03,
                 engine="loop", t0=0.0, absorption_fn=None,
                 axisymmetric=False, dtype=torch.float64, device=None):
    """Image of a 3-D emissivity field: each pixel's ray is seeded exactly
    on its analytic geodesic at r = r_start and marched inward,
    accumulating I = int j(t, r, m, phi) e^{-tau} dl.

    `emissivity_fn(t, r, m, phi)` -> emissivity; rays start at t = t0 and t
    decreases along the (backward) march, so time-dependent sources see
    retarded time.  `absorption_fn(t, r, m, phi)` -> alpha (optional)
    switches on optically thick transfer, tau = int alpha dl toward the
    observer.

    engine="loop" marches with the torch step loop in `dtype` and takes any
    callables; engine="scan" is the reverse-differentiable engine
    (`_volume_march_scan`: checkpointed segments, every one of max_steps
    steps paid) for gradients in the spin and the sources' tensor
    parameters; engine="kernel" marches with the f32 march kernel, which
    takes any callables of the elementwise ops of `march.model_trace.OPS`
    (traced on every call, before the seed; one build of the kernel a
    structure, at first use; data-dependent control flow or another op
    raises TypeError): the seed runs in
    `dtype`, then the state is cast to f32 for the kernel, as the JAX
    package's "pallas" engine does.  The kernel engine is forward only:
    with an input that requires grad, or a callable that captures one, it
    raises.  `axisymmetric=True` declares the source independent of phi:
    the seed skips its azimuth stage (the largest part of the seed: all
    four trajectory types' radial integrals, in f64) and starts every ray
    at phi = 0.  `device=None` means the card.  Returns I, (npix, npix), 0 on pixels
    without a valid seed.
    """
    if engine not in ("loop", "scan", "kernel"):
        raise ValueError(f"engine {engine!r}: 'loop', 'scan' or 'kernel'")
    if engine == "kernel" and _requires_grad(a, incl, t0, emissivity_fn,
                                             absorption_fn):
        raise ValueError("the kernel engine is forward only: an input "
                         "requires grad; use engine='scan' for gradients")
    if engine == "kernel":
        # traced once a call, before the seed: a refusal comes first, and
        # the march takes this trace
        _, emissivity_fn, absorption_fn = prepare(emissivity_fn,
                                                  absorption_fn)
    st, ok = _volume_seed(a, incl, t0, npix, rmax, r_start, precision,
                          axisymmetric=axisymmetric, dtype=dtype,
                          device=device)
    if engine == "kernel":
        _, _, I = raytrace_kernel(
            _as_f32(st), r_max=r_start * 1.2, max_steps=max_steps,
            error_stop=1e-2, emissivity=emissivity_fn,
            absorption=absorption_fn, active0=ok)
        return torch.where(ok, I, 0.0)
    if engine == "scan":
        return _volume_march_scan(st, ok, r_start, emissivity_fn,
                                  n_steps=max_steps,
                                  absorption_fn=absorption_fn)
    return _volume_march_loop(st, ok, r_start, emissivity_fn, max_steps,
                              absorption_fn=absorption_fn)


def volume_lightcurve(a, incl, emissivity_fn_t, t_obs, **kw):
    """Light curve of a time-dependent source: one `volume_image` per
    observer time t0, with the source evaluated at the ray-local (retarded)
    coordinate time.  Returns the total flux per time as a numpy array."""
    return np.asarray([float(volume_image(a, incl, emissivity_fn_t,
                                          t0=float(t), **kw).sum())
                       for t in np.asarray(t_obs)])

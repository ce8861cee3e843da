"""Step-wise null-geodesic integrator (the "marching" engine) in torch.

Port of `sim5_tpu/march/raytrace.py`: direct integration of
d2x/dlambda2 = -Gamma k k with a curvature-adaptive per-ray step size,
classical RK4 steps, masked revert-and-retry error control and
conserved-quantity error tracking.  Rays run in lockstep; each carries its
own step size and finishes independently through an active mask.

This engine keeps the dtype of its inputs (the JAX engine casts to f64); it
is the f64 reference of the march kernel (`kernel_march.py`).

Accuracy contract (src/sim5unittests.c:151-154): Carter-constant relative
drift < 1e-3 over a full ray at default precision.
"""

import dataclasses

import numpy as np
import torch

from ..core import (kerr_metric, flat_metric,
                    kerr_transport_accel, flat_transport_accel,
                    dotprod, photon_carter_const, r_bh)
from ..core.metric import _as_tensors

RTOPT_NONE = 0
RTOPT_FLAT = 1          # Minkowski instead of Kerr (sim5raytrace.h:21-23)
RTOPT_POLARIZATION = 2  # transport a polarization vector along the ray

# subnormal in f32, as in the JAX engine; kept as it is
_TINY = 1e-40

_TENSOR_FIELDS = ("x", "k", "f", "a", "E", "Q", "kt", "error", "steps",
                  "step_epsilon", "step_epsilon0")


@dataclasses.dataclass(frozen=True)
class RaytraceState:
    """Per-ray integration state (the reference's raytrace_data + x,k).

    `opt_gr`/`opt_pol` select the spacetime and polarization transport.
    `step_epsilon` is the CURRENT per-ray step-size parameter: the
    revert-and-retry controller halves it when a step's error trips the
    gate and relaxes it back toward `step_epsilon0` on accepted steps.
    """
    x: torch.Tensor        # (...,4) position [t, r, m=cos(theta), phi]
    k: torch.Tensor        # (...,4) photon momentum
    f: torch.Tensor        # (...,4) polarization vector (zeros if unused)
    a: torch.Tensor        # BH spin (broadcast)
    E: torch.Tensor        # initial energy -k_t
    Q: torch.Tensor        # initial Carter constant
    kt: torch.Tensor       # current k_t (drift monitor)
    error: torch.Tensor    # last ACCEPTED step's relative error
    steps: torch.Tensor    # int32 trial counter ("pass" in the reference)
    step_epsilon: torch.Tensor
    step_epsilon0: torch.Tensor
    opt_gr: bool = True    # GR vs flat
    opt_pol: bool = False  # transport f

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_numpy(cls, d, device="cuda"):
        """State from a dict of numpy arrays, e.g. the fields of a
        `sim5_tpu` RaytraceState, on `device` (the card unless the caller
        asks for the CPU); dtypes are kept."""
        kw = {name: torch.as_tensor(np.array(d[name]), device=device)
              for name in _TENSOR_FIELDS}
        return cls(**kw, opt_gr=bool(d["opt_gr"]), opt_pol=bool(d["opt_pol"]))

    def numpy(self):
        """The state as a dict of numpy arrays (the inverse of `from_numpy`)."""
        d = {name: getattr(self, name).detach().cpu().numpy()
             for name in _TENSOR_FIELDS}
        d.update(opt_gr=self.opt_gr, opt_pol=self.opt_pol)
        return d


def _transport(state, r, m, U, V):
    """-Gamma^i_jk U^j V^k at (r, m), fused (no dense connection tensor)."""
    if state.opt_gr:
        return kerr_transport_accel(state.a, r, m, U, V)
    return flat_transport_accel(r, m, U, V)


def _metric(state, r, m):
    return (kerr_metric(state.a, r, m) if state.opt_gr
            else flat_metric(r, m))


def raytrace_prepare(a, x, k, f=None, precision=0.01, options=RTOPT_NONE):
    """Initialize the integration state; checks are soft (NaN-poisoning).

    Dtype and device follow `x` and `k` (numpy inputs go to the card).
    (reference: raytrace_prepare, sim5raytrace.c:44-94)
    """
    x, k = _as_tensors(x, k)
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    a = a.expand(x.shape[:-1])
    opt_gr = not (options & RTOPT_FLAT)
    opt_pol = bool(options & RTOPT_POLARIZATION)
    f = (torch.zeros_like(k) if f is None
         else torch.as_tensor(f, dtype=x.dtype, device=x.device))
    m = (kerr_metric(a, x[..., 1], x[..., 2]) if opt_gr
         else flat_metric(x[..., 1], x[..., 2]))
    E = k[..., 0] * m.g00 + k[..., 3] * m.g03
    Q = photon_carter_const(k, m)
    eps = torch.sqrt(torch.tensor(precision, dtype=x.dtype,
                                  device=x.device)) / 10.0
    eps = eps.expand(a.shape)
    return RaytraceState(x, k, f, a, E, Q, E, torch.zeros_like(E),
                         torch.zeros(a.shape, dtype=torch.int32,
                                     device=x.device),
                         eps, eps, opt_gr, opt_pol)


def _with_col2(x, v):
    """x with its poloidal column replaced by v."""
    return torch.cat([x[..., :2], v[..., None], x[..., 3:]], -1)


def _rk4_step(state: RaytraceState, dl, dk_at_x=None):
    """One classical RK4 step of (x, k[, f]) with theta as the poloidal
    coordinate during the step (the reference does the same inside its RK4
    fallback, sim5raytrace.c:269-298).

    `dk_at_x`: optional precomputed -Gamma k k at the current point (the
    caller's adaptive-step curvature evaluation is the same quantity)."""
    x = state.x
    k = state.k
    f = state.f
    # switch m=cos(theta) -> theta
    xth = _with_col2(x, torch.arccos(torch.clamp(x[..., 2], -1.0, 1.0)))
    dl_ = dl[..., None]

    def accel(xp, kp, fp):
        rp, mp = xp[..., 1], torch.cos(xp[..., 2])
        dk = _transport(state, rp, mp, kp, kp)
        # parallel transport: df^i = -Gamma^i_jk k^j f^k
        df = _transport(state, rp, mp, kp, fp) if state.opt_pol else fp
        return dk, df

    k1 = k
    if dk_at_x is None:
        dk1, df1 = accel(xth, k1, f)
    else:
        dk1 = dk_at_x
        df1 = (_transport(state, x[..., 1], x[..., 2], k, f)
               if state.opt_pol else f)
    k2 = k + dk1 * 0.5 * dl_
    dk2, df2 = accel(xth + k1 * 0.5 * dl_, k2, f + df1 * 0.5 * dl_)
    k3 = k + dk2 * 0.5 * dl_
    dk3, df3 = accel(xth + k2 * 0.5 * dl_, k3, f + df2 * 0.5 * dl_)
    k4 = k + dk3 * dl_
    dk4, df4 = accel(xth + k3 * dl_, k4, f + df3 * dl_)

    xn = xth + dl_ / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    kn = k + dl_ / 6.0 * (dk1 + 2.0 * dk2 + 2.0 * dk3 + dk4)
    fn = (f + dl_ / 6.0 * (df1 + 2.0 * df2 + 2.0 * df3 + df4)
          if state.opt_pol else f)
    xn = _with_col2(xn, torch.cos(xn[..., 2]))
    return xn, kn, fn


def raytrace_step(state: RaytraceState, max_step=1e9, active=None,
                  error_gate=2.5e-3):
    """Advance every (active) ray by one adaptive step with masked
    revert-and-retry error control.

    Step size: dl = min(max_step, eps / sum_i |dk_i|/|k_i|)
    (reference: sim5raytrace.c:164-166).  When the step error exceeds
    `error_gate`, the step is REJECTED: position/momentum keep their old
    values and the ray's step_epsilon is halved, so the next trial retries
    the same step at half size.  Accepted steps relax epsilon back toward
    its initial value.  Epsilon is floored at eps0/64: once there, steps
    are accepted unconditionally and the caller's error_stop gate decides
    the ray's fate.

    Returns (state, dl_taken); dl is 0 where inactive (rejected trials
    report the attempted dl).
    """
    if active is None:
        active = torch.ones(state.x.shape[:-1], dtype=torch.bool,
                            device=state.x.device)
    eps0 = state.step_epsilon0
    dk = _transport(state, state.x[..., 1], state.x[..., 2], state.k, state.k)
    curv = torch.sum(torch.abs(dk) / (torch.abs(state.k) + _TINY), -1) + _TINY
    # clamp propagates NaN, as jnp.minimum does
    dl = torch.clamp(state.step_epsilon / curv, max=max_step)
    # progress floor, scaled down with the retry shrink so retries do bite
    dl = torch.maximum(dl, 1e-3 * state.step_epsilon / eps0)
    dl = torch.where(active, dl, 0.0)

    xn, kn, fn = _rk4_step(state, dl, dk_at_x=dk)
    mn = _metric(state, xn[..., 1], xn[..., 2])
    kt_new = kn[..., 0] * mn.g00 + kn[..., 3] * mn.g03
    kk = torch.abs(dotprod(kn, kn, mn))
    err = torch.maximum(torch.abs(kt_new - state.kt)
                        / (torch.abs(state.kt) + _TINY), kk)

    # reject non-finite or over-gate trials while the ray still has shrink
    # budget; at the floor a FINITE over-gate trial is accepted and the
    # march loop's error_stop gate decides the ray's fate, but a NON-FINITE
    # trial is never written: the ray FREEZES at its last finite state
    # with error = inf, so the march loop deactivates it without a NaN
    # position ever entering the batch (polar-pass coordinate pathologies)
    bad = ~torch.isfinite(err) | ~torch.isfinite(xn[..., 1])
    reject = active & (bad | (err > error_gate)) \
        & (state.step_epsilon > eps0 / 64.0)
    fail_floor = active & bad & ~reject
    acc = active & ~reject & ~bad
    eps_new = torch.where(reject, torch.maximum(0.5 * state.step_epsilon,
                                                eps0 / 128.0),
                          torch.where(acc, torch.minimum(eps0,
                                                         1.3 * state.step_epsilon),
                                      state.step_epsilon))

    sel = acc[..., None]
    return state._replace(
        x=torch.where(sel, xn, state.x),
        k=torch.where(sel, kn, state.k),
        f=torch.where(sel, fn, state.f),
        kt=torch.where(acc, kt_new, state.kt),
        error=torch.where(acc, err,
                          torch.where(fail_floor, torch.inf, state.error)),
        steps=state.steps + active.to(torch.int32),
        step_epsilon=eps_new,
    ), dl


def raytrace_error(state: RaytraceState):
    """Global integration error: relative Carter-constant drift.

    (reference: raytrace_error, sim5raytrace.c:327-343)
    """
    m = _metric(state, state.x[..., 1], state.x[..., 2])
    Q = photon_carter_const(state.k, m)
    return torch.abs(Q - state.Q) / (torch.abs(state.Q) + _TINY)


def raytrace(state: RaytraceState, r_max=1e4, max_steps=10000,
             error_stop=1e-2):
    """Integrate all rays until they fall below 1.05*r_bh, escape past
    r_max, exceed the error gate, or hit max_steps.

    The loop condition is read on the host once per step.
    Returns (final_state, active_mask_still_running).
    """
    r_min = 1.05 * r_bh(state.a)
    active = torch.ones(state.x.shape[:-1], dtype=torch.bool,
                        device=state.x.device)
    while bool(active.any() & (state.steps.max() < max_steps)):
        state, _ = raytrace_step(state, active=active,
                                 error_gate=0.25 * error_stop)
        r = state.x[..., 1]
        active = (active & (r > r_min) & (r < r_max)
                  & (state.error < error_stop) & torch.isfinite(r))
    return state, active

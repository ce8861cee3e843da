"""Kerr and Minkowski metric, Christoffel connection entries and 4-vector
algebra in Boyer-Lindquist coordinates (t, r, theta, phi).

Port of `sim5_tpu/core/metric.py` (the part the stepwise march needs).  The
poloidal coordinate is m = cos(theta) everywhere, as in the reference.
Dtype and device follow the inputs (`_as_tensors`); inputs that hold no
tensor go to the card.

(reference: sim5kerr.c:30-625)
"""

import dataclasses

import numpy as np
import torch


def default_device(device=None):
    """`device`, or CUDA when it is None: the port runs on the card unless
    the caller asks for the CPU (with CPU tensors or `device="cpu"`)."""
    return torch.device("cuda" if device is None else device)


def _as_tensors(*vals, device=None):
    """Broadcast `vals` to tensors of one floating dtype and device.

    Dtype and device come from the first torch tensor among `vals`.  With
    no tensor, the dtype comes from the first floating numpy array (else
    float64) and the device from `default_device(device)`.
    """
    ref = next((v for v in vals if isinstance(v, torch.Tensor)), None)
    if ref is not None:
        dtype = ref.dtype if ref.is_floating_point() else torch.float64
        device = ref.device
    else:
        arr = next((v for v in vals if isinstance(v, np.ndarray)
                    and v.dtype.kind == "f"), None)
        dtype = torch.float64 if arr is None else torch.as_tensor(arr).dtype
        device = default_device(device)
    return torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=dtype, device=device) for v in vals))


@dataclasses.dataclass(frozen=True)
class Metric:
    """Covariant metric components at a point."""
    a: torch.Tensor
    r: torch.Tensor
    m: torch.Tensor    # cos(theta)
    g00: torch.Tensor
    g11: torch.Tensor
    g22: torch.Tensor
    g33: torch.Tensor
    g03: torch.Tensor


def flat_metric(r, m):
    """Minkowski metric in spherical coordinates.  (sim5kerr.c:31-48)"""
    r, m = _as_tensors(r, m)
    z = torch.zeros_like(r)
    return Metric(z, r, m, -torch.ones_like(r), torch.ones_like(r),
                  r * r, r * r * (1.0 - m * m), z)


def kerr_metric(a, r, m):
    """Covariant Kerr metric g_munu.  (sim5kerr.c:75-101)"""
    a, r, m = _as_tensors(a, r, m)
    r2, a2, m2 = r * r, a * a, m * m
    S = r2 + a2 * m2
    s2_S = (1.0 - m2) / S
    return Metric(
        a, r, m,
        -1.0 + 2.0 * r / S,
        S / (r2 - 2.0 * r + a2),
        S,
        ((a2 + r2) * S + 2.0 * r * a2 * s2_S * S) * s2_S,
        -2.0 * a * r * s2_S,
    )


def _flat_conn_entries(r, m):
    """Nonzero Christoffel components {(i,j<=k): Gamma^i_jk} for Minkowski
    in spherical coords.  (sim5kerr.c:199-228)"""
    r, m = _as_tensors(r, m)
    s = torch.sqrt(1.0 - m * m)
    e = {
        (1, 2, 2): -r,
        (1, 3, 3): -r * s * s,
        (2, 1, 2): 1.0 / r,
        (2, 3, 3): -m * s,
        (3, 1, 3): 1.0 / r,
        (3, 2, 3): m / s,
    }
    return e, r.shape


def _kerr_conn_entries(a, r, m):
    """Nonzero Christoffel components {(i,j<=k): Gamma^i_jk} for Kerr.
    (sim5kerr.c:233-316; the reference's 2x premultiplication of
    off-diagonal terms is undone here)

    Gamma^theta_{t phi} divides by `a`: at a = 0 it is 0/0, as in the
    reference (sim5kerr.c:281).
    """
    a, r, m = _as_tensors(a, r, m)
    rS = 2.0 * r
    s = torch.sqrt(1.0 - m * m)
    cs = s * m
    c2 = m * m
    s2 = s * s
    cc = c2 - s2
    CC = 8.0 * c2 * c2 - 8.0 * c2 + 1.0
    a2 = a * a
    a4 = a2 * a2
    a2cc = a2 * cc
    a2c2 = a2 * c2
    a2cs = a2 * cs
    a4CC = a4 * CC
    r2 = r * r
    r3 = r2 * r
    r4 = r2 * r2
    a2r2 = a2 * r2
    a2_r2 = a2 + r2
    R = (a2 + 2.0 * r2 + a2cc) ** 2
    D = r2 - 2.0 * r + a2
    S = r2 + a2c2
    S_1 = 1.0 / S
    S_3 = 1.0 / (S * S * S)
    D_1 = 1.0 / D
    R_1 = 1.0 / R
    m_s = m / s
    DR_1 = D_1 * R_1
    DS_1 = D_1 * S_1
    dbl_r2 = 2.0 * r2

    G100 = D * (r2 - a2c2) * S_3
    G200 = -2.0 * r * a2cs * S_3
    G002 = -4.0 * a2cs * rS * R_1

    e = {
        (0, 0, 1): 4.0 * a2_r2 * (r2 - a2c2) * DR_1,
        (0, 0, 2): G002,
        (0, 1, 3): 2.0 * a * s2 * (a4 - 3.0 * a2r2 - 6.0 * r4 + a2cc * (a2 - r2)) * DR_1,
        (0, 2, 3): -G002 * s2 * a,
        (1, 0, 0): G100,
        (1, 0, 3): -G100 * a * s2,
        (1, 1, 1): (r * (a2 - r) + a2 * (1.0 - r) * c2) * DS_1,
        (1, 1, 2): -a2cs * S_1,
        (1, 2, 2): -r * D * S_1,
        (1, 3, 3): -D * s2 * (2.0 * a2c2 * r3 + r2 * r3 + a2 * a2c2 * s2
                              + a2c2 * a2c2 * r - a2r2 * s2) * S_3,
        (2, 0, 0): G200,
        (2, 0, 3): -G200 * a2_r2 / a,
        (2, 1, 1): a2cs * DS_1,
        (2, 1, 2): r * S_1,
        (2, 2, 2): -a2cs * S_1,
        (2, 3, 3): -cs * (a2_r2 * S * S + a2 * s2 * rS * (a2_r2 + S)) * S_3,
        (3, 0, 1): a * (r2 - a2c2) * DS_1 * S_1,
        (3, 0, 2): -4.0 * a * rS * m_s * R_1,
        (3, 1, 3): 0.5 * (a4 + 3.0 * a4 * r - 12.0 * a2r2 + 8.0 * a2 * r3
                          - 16.0 * r4 + 8.0 * r2 * r3
                          + 4.0 * r * (dbl_r2 - r + a2) * a2cc
                          - a4CC * (1.0 - r)) * DR_1,
        (3, 2, 3): 0.5 * ((3.0 * a4 + 8.0 * a2 * r + 8.0 * a2r2 + 8.0 * r4
                           + 4.0 * (dbl_r2 - 2.0 * r + a2) * a2cc + a4CC) * m_s) * R_1,
    }
    return e, r.shape


def _sparse_transport(entries, U, V):
    """-Gamma^i_{jk} U^j V^k contracted directly from the nonzero component
    dict (j<=k entries; Gamma symmetric in jk), with U, V as (..., 4).

    No dense (..., 4, 4, 4) connection is ever built.  Each symmetrized
    product U^j V^k + U^k V^j is formed once and shared by the entries that
    use it (eager torch pays per operation, not per element).
    """
    Us, Vs = U.unbind(-1), V.unbind(-1)
    pairs = {}
    out = [None, None, None, None]
    for (i, j, k), g in entries.items():
        if (j, k) not in pairs:
            pairs[j, k] = (Us[j] * Vs[k] + Us[k] * Vs[j] if j != k
                           else Us[j] * Vs[k])
        term = g * pairs[j, k]
        out[i] = term if out[i] is None else out[i] + term
    out = [torch.zeros_like(Us[0]) if o is None else o for o in out]
    return -torch.stack(torch.broadcast_tensors(*out), -1)


def kerr_transport_accel(a, r, m, U, V):
    """-Gamma^i_{jk} U^j V^k for Kerr without the dense tensor.

    With U = V = k this is the geodesic acceleration; with U = k, V = f it
    is the parallel-transport derivative.
    """
    e, _ = _kerr_conn_entries(a, r, m)
    return _sparse_transport(e, U, V)


def flat_transport_accel(r, m, U, V):
    """-Gamma^i_{jk} U^j V^k for Minkowski (spherical) without the dense
    tensor."""
    e, _ = _flat_conn_entries(r, m)
    return _sparse_transport(e, U, V)


# -----------------------------------------------------------------
# 4-vector algebra  (sim5kerr.c:443-625)
# -----------------------------------------------------------------

def vector_covariant(V, metric: Metric):
    """Lower the index: X^mu -> X_mu.  (sim5kerr.c:477-499)"""
    V = torch.as_tensor(V, dtype=metric.g00.dtype, device=metric.g00.device)
    return torch.stack([
        V[..., 0] * metric.g00 + V[..., 3] * metric.g03,
        V[..., 1] * metric.g11,
        V[..., 2] * metric.g22,
        V[..., 3] * metric.g33 + V[..., 0] * metric.g03,
    ], -1)


def dotprod(V1, V2, metric: Metric = None):
    """Scalar product U.V; flat metric when `metric` is None.  (sim5kerr.c:608-625)"""
    if metric is None:
        return (-V1[..., 0] * V2[..., 0] + V1[..., 1] * V2[..., 1]
                + V1[..., 2] * V2[..., 2] + V1[..., 3] * V2[..., 3])
    return (V1[..., 0] * V2[..., 0] * metric.g00
            + V1[..., 1] * V2[..., 1] * metric.g11
            + V1[..., 2] * V2[..., 2] * metric.g22
            + V1[..., 3] * V2[..., 3] * metric.g33
            + (V1[..., 0] * V2[..., 3] + V1[..., 3] * V2[..., 0]) * metric.g03)

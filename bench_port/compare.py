"""The numbers the judges compare, on CPU tensors.

Every function returns a float that is 0 for identical answers and grows
with their distance; a NaN anywhere in either answer gives NaN, which no
limit admits.
"""

import torch


def _nan_if_any(*ts):
    return any(bool(torch.isnan(t).any()) for t in ts)


def image_err(got, want):
    """max |got - want| over the pixels both light, over the peak of
    `want`, for each frame of (n, ny, nx); the largest."""
    got, want = got.double(), want.double()
    if _nan_if_any(got, want):
        return float("nan")
    out = 0.0
    for g, w in zip(got, want):
        both = (g > 0) & (w > 0)
        if both.any():
            out = max(out, float((g - w).abs()[both].max() / w.max()))
    return out


def footprint(got, want):
    """The share of pixels lit in one image and dark in the other, the
    largest over the frames of (n, ny, nx)."""
    if _nan_if_any(got.double(), want.double()):
        return float("nan")
    return float(((got > 0) != (want > 0)).double().mean((-2, -1)).max())


def g_err(got_f, got_g, want_f, want_g):
    """max |got_g - want_g| over the pixels both images light (image_f > 0
    in both, as `image_err` takes them; a pixel lit in one only is the
    footprint's), the largest over the frames; a g-factor is of order 1,
    so the distance is absolute."""
    got_g, want_g = got_g.double(), want_g.double()
    if _nan_if_any(got_f.double(), want_f.double(), got_g, want_g):
        return float("nan")
    both = (got_f > 0) & (want_f > 0)
    return float((got_g - want_g).abs()[both].max()) if both.any() else 0.0


def rel_err(got, want, floor=None):
    """max |got - want| / max(|want|, floor) over the entries: each entry
    against itself, or against `floor` where that is larger."""
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64)
    if _nan_if_any(got, want):
        return float("nan")
    den = (want.abs() if floor is None else torch.maximum(
        want.abs(), torch.as_tensor(floor, dtype=torch.float64)))
    return float(((got - want).abs() / den).max())


def peak_err(got, want):
    """max |got - want| over the peak |want|."""
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64)
    if _nan_if_any(got, want):
        return float("nan")
    return float((got - want).abs().max() / want.abs().max())


def sum_err(got, want):
    """|sum(got) - sum(want)| / |sum(want)|."""
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64)
    if _nan_if_any(got, want):
        return float("nan")
    return float((got.sum() - want.sum()).abs() / want.sum().abs())

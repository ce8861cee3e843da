"""The host boundary of the tables and checkpoints: tensors on any device
to numpy, and run metadata to plain JSON values.

The JAX package writes np.asarray(x) at these points, which raises on a
CUDA tensor; and a tensor in a table's or checkpoint's meta would break
json.dumps, or compare unequal on reopening and silently stop a resume.
"""

import json

import numpy as np
import torch


def host_f64(x):
    """`x` (a tensor on any device, a numpy array, a number or a sequence
    of them) as a float64 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    elif isinstance(x, (list, tuple)):
        x = [host_f64(v) for v in x]
    return np.asarray(x, np.float64)


def _plain(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.item() if v.numel() == 1 else v.tolist()
    if isinstance(v, (np.generic, np.ndarray)):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _plain(u) for k, u in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(u) for u in v]
    return v


def json_roundtrip(meta):
    """Meta as it reads back from a JSON manifest, tensors and numpy values
    as Python numbers and lists (so resume comparisons are type-stable:
    tuples -> lists, scalars -> Python numbers)."""
    return json.loads(json.dumps(_plain(dict(meta or {}))))

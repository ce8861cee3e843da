"""What the march kernel's segmented schedule relies on, checked on the CPU.

The CUDA kernel (`sim5_tpu_torch/csrc/march.cu`) runs only on the card
(chip_smoke.py holds its schedules bitwise equal there).  Here: the ctypes
signatures the wrapper declares match the `extern "C"` functions of the
source, the plain version's results do not depend on where a ray sits in
the batch (what compaction of live rays relies on), the CUDA wrappers
refuse CPU tensors before anything is built, and the build uses no fast
math.  No test here compiles anything with JAX.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from sim5_tpu_torch import _build
from sim5_tpu_torch.core import kerr_metric, tetrad_zamo, on2bl
from sim5_tpu_torch.march import (raytrace_prepare, kernel_march,
                                  RTOPT_POLARIZATION)
from sim5_tpu_torch.march.emission import GaussianSource

# C parameter types of the launchers -> the ctypes type the wrapper must use
C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float}


def _extern_c_functions():
    """{name: (restype, [ctypes type of each parameter])} of every
    `extern "C"` function in csrc/*.cu."""
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C"\s+(\w+)\s+(\w+)\(([^)]*)\)', text):
            ret, name, params = m[1], m[2], m[3]
            kinds = []
            for p in params.split(","):
                decl = " ".join(p.replace("const", " ").split())
                if "*" in decl:
                    kinds.append(ctypes.c_void_p)
                else:
                    kinds.append(C_TYPES[decl.rsplit(" ", 1)[0]])
            found[name] = (None if ret == "void" else C_TYPES[ret], kinds)
    return found


def _rays(n, pol=False, seed=5):
    """A prepared f32 CPU state of ZAMO rays from a numpy seed."""
    rng = np.random.default_rng(seed)

    def t(v):
        return torch.as_tensor(v, dtype=torch.float32)

    r, m = t(rng.uniform(6.0, 15.0, n)), t(rng.uniform(-0.5, 0.5, n))
    th, ph = rng.uniform(0.3, np.pi - 0.3, n), rng.uniform(0, 2 * np.pi, n)
    T = tetrad_zamo(kerr_metric(t(0.9), r, m))
    d = np.stack([np.sin(th) * np.cos(ph) + 0.5, np.sin(th) * np.sin(ph),
                  np.cos(th)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kloc = t(np.concatenate([np.ones((n, 1)), d], -1))
    k = on2bl(kloc, T)
    x = torch.stack([torch.zeros_like(r), r, m, torch.zeros_like(r)], -1)
    f0 = on2bl(t([0.0, 0.0, 1.0, 0.0]).expand(n, 4), T) if pol else None
    return raytrace_prepare(0.9, x, k, f=f0, precision=0.01,
                            options=RTOPT_POLARIZATION if pol else 0)


def _bits(v):
    return v.view(torch.int32) if v.dtype == torch.float32 else v


class TestSchedule:

    def test_ctypes_signatures_match_the_extern_c_functions(self):
        found = _extern_c_functions()
        assert set(found) == set(kernel_march.SIGNATURES)
        for name, (argtypes, restype) in kernel_march.SIGNATURES.items():
            c_ret, c_args = found[name]
            assert restype is c_ret, name
            assert len(argtypes) == len(c_args), name
            for i, (ours, theirs) in enumerate(zip(argtypes, c_args)):
                assert ours is theirs, f"{name} parameter {i}"

    @pytest.mark.parametrize("case", ["gr", "gr+pol", "gr thick transfer"])
    def test_reference_is_invariant_to_ray_order(self, case):
        n = 64
        st = _rays(n, pol=case == "gr+pol")
        kt = st.kt.clone()
        kt[7] = float("nan")                 # inactive on entry
        st = st._replace(kt=kt)
        active0 = torch.arange(n) % 5 != 2
        tensors, scalars = kernel_march._pack(st, 16.0, 40, 1e-2, active0)
        if case == "gr thick transfer":
            blob = GaussianSource(amp=1.0, center=9.0, inv_width=0.5,
                                  inv_height=0.5, cylindrical=True)
            scalars.update(emissivity=blob, absorption=blob)
        perm = torch.from_numpy(np.random.default_rng(1).permutation(n))
        permuted = [v[..., perm] for v in tensors]
        outs = kernel_march.march_reference(*tensors, **scalars)
        outs_p = kernel_march.march_reference(*permuted, **scalars)
        steps = outs[5]
        assert (steps == 40).any() and (steps < 40).any() and (steps == 0).any()
        for a, b in zip(outs, outs_p):
            if a is None:
                assert b is None
                continue
            assert torch.equal(_bits(a[..., perm]), _bits(b))

    def test_cuda_wrappers_refuse_cpu_tensors_before_building(self):
        st = _rays(8)
        tensors, scalars = kernel_march._pack(st, 50.0, 10, 1e-2, None)
        lib = kernel_march._LIB
        for launch in (kernel_march._march_cuda,
                       kernel_march._march_cuda_one_launch):
            with pytest.raises(ValueError, match="the kernel needs"):
                launch(*tensors, **scalars)
        assert kernel_march._LIB is lib
        assert kernel_march.LAUNCHES == dict.fromkeys(kernel_march.LAUNCHES, 0)

    def test_build_has_no_fast_math(self):
        assert not any("fast" in f for f in _build.NVCC_FLAGS)
        for src in _build.CSRC.glob("*.cu*"):
            text = src.read_text()
            assert not re.search(r"__(cos|sin|exp|log|fdivide|powf)\w*\(",
                                 text), src

"""Any emissivity and absorption in the march kernel: the tracer and the
emitter of `sim5_tpu_torch.march.model_trace`, checked on the CPU.

* `evaluate(trace_model(fn))` is bitwise `fn` on seeded inputs, for every
  test model (tests/torch_trace_models.py) and for a model that uses every
  op of `model_trace.OPS`: the trace keeps the callable's ops, in order,
  with its constants as the f32 torch used;
* the emitted functors, compiled as host C++ by g++ (`SIM5_HD` is inline
  outside nvcc; -ffp-contract=off), are within 1e-5 of the peak of the
  torch callable on 10^4 seeded inputs, with NaN where torch gives NaN:
  negative remainders, NaN into maximum, minimum and clamp, and inputs on
  the edges of `where` are among them.  1e-5 of the peak: libm's f32
  functions and torch's vectorised ones (Sleef) differ by a few ulp, and
  a sum of terms of different sizes carries them at the largest's scale;
* models that differ only in their numbers have one key, one functor and
  one march library source; models of another structure do not;
* every refusal raises before anything is built or launched;
* the generated library's entry points match the signatures the wrapper
  declares, and nothing emitted uses a fast-math intrinsic.

The torch models are held against their jnp twins here too, so the
traced-route tests (test_torch_volume_traced.py) compare like with like.
"""

import ctypes
import re
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

import torch_trace_models as tm
from sim5_tpu_torch import _build
from sim5_tpu_torch.march import kernel_march, model_trace
from sim5_tpu_torch.march.emission import GaussianSource
from sim5_tpu_torch.render import lightcurve as tlc

torch.set_num_threads(2)

# a captured 0-dim tensor of another dtype: lifted as the f32 torch uses
C64 = torch.tensor(0.7, dtype=torch.float64)


def every_unary(t, r, m, phi):
    """Every op of one operand (inputs: r >= 1.2, |m| <= 1)."""
    return (torch.exp(-r) + torch.log(r) + torch.sqrt(r) + torch.cos(phi)
            + torch.sin(phi) + torch.tan(m) + torch.tanh(m) + torch.sinh(m)
            + torch.cosh(m) + torch.asin(m) + torch.acos(m) + torch.atan(m)
            + torch.abs(t) + torch.floor(t) + torch.ceil(t) + torch.trunc(t)
            + torch.round(t) + torch.expm1(m) + torch.log1p(r)
            + torch.log2(r) + torch.log10(r) + torch.exp2(m) + torch.erf(m)
            + torch.erfc(m) + torch.rsqrt(r) + torch.reciprocal(r)
            + torch.sigmoid(m) - m)


def every_binary(t, r, m, phi):
    """Every op of two operands, pow in each of its forms."""
    return (torch.atan2(m, phi) + torch.fmax(m, phi) + torch.fmin(m, phi)
            + torch.fmod(t, 3.0) + torch.fmod(phi, r)
            + torch.remainder(t, 2.5) + torch.remainder(phi, -1.5)
            + torch.remainder(t, r) + torch.remainder(-2.5, r)
            + 1e-3 * (r ** 2 + r ** 3 + r ** 0.5 + r ** -0.5 + r ** -1
                      + r ** -2 + r ** 1.7 + r ** m + 2.0 ** m)
            + (1.0 - m) + torch.sub(r, m) + torch.mul(r, 2)
            + torch.div(m, r) + torch.add(m, 1.5))


def every_logical(t, r, m, phi):
    """Comparisons, the logical and bitwise ops on bools, and where."""
    cond = ((r > 3.0) & (m < 0.2)) | (~(phi >= 1.0) ^ (t <= -5.0))
    return (torch.where(cond, 1.0, 0.5) + torch.where(r > 2.0, r, m)
            + torch.where(m >= 0.0, 0.25, m) + torch.where(m < 0.0, m, 0.75)
            + torch.logical_xor(r > 4.0, m < 0.0).float()
            + torch.logical_or(r == 2.0, m != 0.0) * 2.0
            + torch.logical_and(r <= 5.0, torch.logical_not(t == 0.0)) * 3.0
            + (torch.bitwise_not(r > 6.0) & (m > r)).float()
            + ((r >= m) | (m <= phi) ^ (m < phi)).float()
            + ((t == r) | (t != m)).float())


def every_bound(t, r, m, phi):
    """maximum, minimum and clamp in their forms; fills and captured and
    inline constants."""
    return (torch.maximum(r, m) + torch.minimum(m, phi)
            + torch.clamp(m, -0.3, 0.4) + torch.clamp(phi, min=0.0)
            + torch.clamp(phi, max=0.1) + torch.clamp_min(m, -0.2)
            + torch.clamp_max(m, 0.2) + torch.clamp(m, min=phi, max=r)
            + torch.clamp_min(m, phi) + torch.clamp_max(m, phi)
            + torch.full_like(r, 3.0) + torch.zeros_like(r)
            + torch.ones_like(m) + C64 * r
            + torch.tensor(2.0) * torch.tensor(1.5) * m + r.clone().detach())


EVERY = (every_unary, every_binary, every_logical, every_bound)


def nan_minmax(t, r, m, phi):
    """maximum / minimum / clamp with NaN in their operands."""
    return (torch.maximum(m, phi) + torch.minimum(phi, m)
            + torch.clamp(phi, -1.0, 1.0) + torch.clamp(m, min=phi))


def _torch_models():
    models = {k: make(torch) for k, make in tm.MODELS.items()}
    models.update({f.__name__: f for f in EVERY})
    models.update(
        gauss_arc=GaussianSource(amp=2.0, center=7.0, inv_width=1 / 0.7,
                                 inv_height=1 / 0.7, cylindrical=True,
                                 t_center=-5.0, inv_duration=0.1,
                                 phi_center=0.3, omega=0.05,
                                 inv_arc=1 / 0.7),
        torus_family=GaussianSource(amp=1.0, center=8.0, inv_width=1 / 1.5,
                                    inv_height=1 / 1.5, cylindrical=True))
    return models


MODELS = _torch_models()


def _inputs(n=10000, seed=7, nan=False):
    t, r, m, phi = (torch.from_numpy(v) for v in tm.inputs(n, seed))
    if nan:
        m[::5] = float("nan")
        phi[2::7] = float("nan")
    return t, r, m, phi


@pytest.fixture(autouse=True)
def _inference():
    with torch.inference_mode():
        yield


def _bits(v):
    return v.view(torch.int32)


class TestTrace:

    @pytest.mark.parametrize("name", sorted(MODELS))
    def test_evaluate_is_the_callable_bitwise(self, name):
        fn = MODELS[name]
        tr = model_trace.trace_model(fn)
        assert len(tr.consts) <= model_trace.MAX_CONSTS
        for args in (_inputs(), _inputs(seed=8, nan=True)):
            got, want = model_trace.evaluate(tr, *args), fn(*args)
            assert got.dtype == torch.float32 and got.shape == want.shape
            assert torch.equal(_bits(got), _bits(want)), name

    def test_every_op_is_traced(self):
        used = {f"{op.target._overloadpacket.__name__}."
                f"{op.target._overloadname}"
                for f in EVERY for op in model_trace.trace_model(f).ops}
        left = set(model_trace.OPS) - used
        assert not left, left

    def test_torch_models_match_their_jnp_twins(self):
        args = tm.inputs(4096, 3)
        with jax.enable_x64(False):
            for name, make in tm.MODELS.items():
                want = np.asarray(make(jax.numpy)(*args))
                got = make(torch)(*(torch.from_numpy(v) for v in args))
                peak = np.nanmax(np.abs(want))
                err = np.nanmax(np.abs(got.numpy() - want))
                assert err <= 1e-5 * peak, (name, err, peak)

    def test_constants_only_share_a_key_and_a_source(self):
        pairs = [(tm.flare(torch, t_flare=-30.0),
                  tm.flare(torch, t_flare=-12.5)),
                 (tm.make_alpha(torch, 0.05), tm.make_alpha(torch, 5.0)),
                 (tm.flare(torch, r_spot=8.0), tm.flare(torch, r_spot=6.0)),
                 (MODELS["gauss_arc"],
                  GaussianSource(amp=3.0, center=6.0, inv_width=1.0,
                                 inv_height=2.0, cylindrical=True,
                                 t_center=1.0, inv_duration=0.2,
                                 phi_center=-1.0, omega=0.07, inv_arc=2.0))]
        for f, g in pairs:
            a, b = model_trace.trace_model(f), model_trace.trace_model(g)
            assert a.consts != b.consts
            assert a.key == b.key
            assert model_trace.emit_cuda(a) == model_trace.emit_cuda(b)
            assert (model_trace.march_source(a, a)
                    == model_trace.march_source(b, b))
        keys = {model_trace.trace_model(MODELS[n]).key for n in (
            "corona", "corona_alpha", "spiral", "blob", "torus_j",
            "torus_alpha", "flare", "gauss_arc", "torus_family")}
        assert len(keys) == 9
        # an orbiting source is another structure than one that does not
        assert (model_trace.trace_model(MODELS["torus_family"]).key
                != model_trace.trace_model(MODELS["gauss_arc"]).key)

    def test_equal_family_models_share_one_trace(self):
        a = GaussianSource(amp=1.5, center=8.0, inv_width=0.5)
        b = GaussianSource(amp=1.5, center=8.0, inv_width=0.5)
        assert model_trace.trace_model(a) is model_trace.trace_model(b)

    def test_march_source_names_the_models(self):
        j = model_trace.trace_model(MODELS["corona"])
        al = model_trace.trace_model(MODELS["corona_alpha"])
        thin = model_trace.march_source(j)
        thick = model_trace.march_source(j, al)
        assert "constexpr int kModelRT = 1;" in thin
        assert "constexpr int kModelRT = 2;" in thick
        assert f"using ModelJ = sim5::Traced<Model_{j.key}>;" in thick
        assert f"using ModelA = sim5::Traced<Model_{al.key}>;" in thick
        assert thick.index('#include "march.cuh"') < thick.index(
            '#include "march_model.cuh"')
        # one functor when both models have one structure
        same = model_trace.march_source(j, j)
        assert same.count(f"struct Model_{j.key}") == 1


class TestRefusals:
    """Each refusal raises before anything is built or launched, through
    the entry points too."""

    CASES = {
        "reduction": (lambda t, r, m, phi: r.sum() * m, TypeError, "sum"),
        "indexing": (lambda t, r, m, phi: r[0] * m, TypeError, "select"),
        "reshape": (lambda t, r, m, phi: r.reshape(2, -1).flatten() * m,
                    TypeError, "view"),
        "dtype": (lambda t, r, m, phi: (r.double() * m).float(), TypeError,
                  "_to_copy"),
        "control flow": (lambda t, r, m, phi: r if bool((r > 3).all()) else m,
                         TypeError, "data-dependent control flow"),
        "python number": (lambda t, r, m, phi: r * float(m[0]), TypeError,
                          "data-dependent control flow"),
        "captured array": (lambda t, r, m, phi: r * torch.tensor([1.0, 2.0]
                                                                 ).sum(),
                           TypeError, "only 0-dim"),
        "constants": (lambda t, r, m, phi: sum(r * (1.0 + k)
                                               for k in range(40)),
                      TypeError, "more than 32 constants"),
        "bool result": (lambda t, r, m, phi: r > 2.0, TypeError, "returns"),
        "tuple result": (lambda t, r, m, phi: (r, m), TypeError, "returns"),
        "requires grad": (lambda t, r, m, phi: GRAD * r, ValueError,
                          "requires grad"),
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_refused_before_any_build_or_launch(self, case):
        fn, exc, match = self.CASES[case]
        with pytest.raises(exc, match=match):
            model_trace.trace_model(fn)
        builds, launches = dict(_build.BUILDS), dict(kernel_march.LAUNCHES)
        seeds = []
        real_seed = tlc._volume_seed
        tlc._volume_seed = lambda *a, **k: seeds.append(1) or real_seed(
            *a, **k)
        try:
            with pytest.raises(exc, match=match):
                tlc.volume_image(0.9, 1.2, MODELS["blob"], engine="kernel",
                                 absorption_fn=fn, device="cpu", npix=4)
            st, _ = real_seed(0.9, 1.2, 0.0, npix=2, rmax=12.0, r_start=20.0,
                              precision=0.03, axisymmetric=True,
                              dtype=torch.float32, device="cpu")
            with pytest.raises(exc, match=match):
                kernel_march.raytrace_kernel(st, emissivity=fn, max_steps=5)
            tensors, scalars = kernel_march._pack(st, 24.0, 5, 1e-2, None)
            with pytest.raises(exc, match=match):
                kernel_march._march_cuda(*tensors, emissivity=fn, **scalars)
        finally:
            tlc._volume_seed = real_seed
        assert not seeds, "the seed ran before the refusal"
        assert _build.BUILDS == builds
        assert kernel_march.LAUNCHES == launches


GRAD = torch.tensor(0.5, requires_grad=True)

# a global that the model below reads, changed between two calls
SCALE = 1.0


def scaled_ring(t, r, m, phi):
    return SCALE * torch.exp(-0.5 * ((r - 8.0) / 2.0) ** 2)


class Ring:
    """A callable object whose number is an attribute."""

    def __init__(self, amp):
        self.amp = amp

    def __call__(self, t, r, m, phi):
        return self.amp * torch.exp(-0.5 * ((r - 8.0) / 2.0) ** 2)


class TestFreshTrace:
    """A callable is traced on every call, so the numbers it reads are
    those of the call (a global, an attribute, a captured tensor changed
    in place), on the kernel's route as on the plain one; a model whose
    numbers cannot change (a GaussianSource) keeps one trace."""

    @pytest.mark.parametrize("kind", ["global", "attribute", "tensor"])
    def test_changed_numbers_are_traced_anew(self, kind):
        global SCALE
        amp = torch.tensor(1.0)
        ring = Ring(1.0)
        fn = {"global": scaled_ring, "attribute": ring,
              "tensor": lambda t, r, m, phi: amp * scaled_ring(t, r, m, phi)
              }[kind]

        def set_scale(v):
            global SCALE
            if kind == "global":
                SCALE = v
            elif kind == "attribute":
                ring.amp = v
            else:
                amp.fill_(v)

        st, ok = tlc._volume_seed(0.9, 1.2, 0.0, npix=6, rmax=12.0,
                                  r_start=20.0, precision=0.03,
                                  axisymmetric=True, dtype=torch.float32,
                                  device="cpu")
        kw = dict(npix=6, rmax=12.0, r_start=20.0, max_steps=200,
                  precision=0.03, axisymmetric=True, dtype=torch.float32,
                  device="cpu")
        got = {}
        try:
            for v in (1.0, 2.0):
                set_scale(v)
                tr = model_trace.trace_model(fn)
                got[v] = (tr, kernel_march.raytrace_kernel(
                    st, r_max=24.0, max_steps=200, emissivity=fn,
                    active0=ok)[2],
                    tlc.volume_image(0.9, 1.2, fn, engine="kernel", **kw))
        finally:
            SCALE = 1.0
        (t1, I1, V1), (t2, I2, V2) = got[1.0], got[2.0]
        assert t1.key == t2.key and t1.consts != t2.consts
        assert float(V1.max()) > 0.0
        # j doubles exactly, so the sums of j dl do
        assert torch.equal(I2, 2.0 * I1)
        assert torch.equal(V2, 2.0 * V1)

    def test_equal_fixed_models_keep_one_trace(self):
        a = GaussianSource(amp=2.5, center=6.0, inv_width=0.5)
        assert model_trace.trace_model(a) is model_trace.trace_model(
            GaussianSource(amp=2.5, center=6.0, inv_width=0.5))
        tr = model_trace.trace_model(MODELS["corona"])
        assert model_trace.trace_model(tr) is tr
        t, r, m, phi = _inputs(64)
        assert torch.equal(_bits(tr(t, r, m, phi)),
                           _bits(MODELS["corona"](t, r, m, phi)))


class TestHostBuild:
    """The emitted functors compiled by g++ against the torch callables."""

    NAMES = sorted(MODELS) + ["nan_minmax"]

    @pytest.fixture(scope="class")
    def host_lib(self, tmp_path_factory):
        gxx = shutil.which("g++")
        if gxx is None:
            pytest.skip("no g++ on this machine: the host build of the "
                        "emitted code cannot be made")
        models = dict(MODELS, nan_minmax=nan_minmax)
        traces = {n: model_trace.trace_model(f) for n, f in models.items()}
        functors = {tr.key: model_trace.emit_cuda(tr)
                    for tr in traces.values()}
        src = ['#include "model.cuh"', *functors.values()]
        for n, tr in traces.items():
            src.append(
                f'extern "C" void eval_{n}(const float* c, const float* t, '
                "const float* r, const float* m, const float* phi, "
                "float* out, int n) {\n"
                f"  for (int i = 0; i < n; ++i) out[i] = Model_{tr.key}()("
                "c, t[i], r[i], m[i], phi[i]);\n}")
        tmp = tmp_path_factory.mktemp("trace_host")
        cpp, lib = tmp / "models.cpp", tmp / "libmodels.so"
        cpp.write_text("\n".join(src) + "\n")
        proc = subprocess.run(
            [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
             "-fPIC", "-I", str(_build.CSRC), "-o", str(lib), str(cpp)],
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        return ctypes.CDLL(str(lib)), traces, models, cpp.read_text()

    @pytest.mark.parametrize("name", NAMES)
    def test_emitted_code_matches_the_callable(self, host_lib, name):
        dll, traces, models, _ = host_lib
        tr, fn = traces[name], models[name]
        for args in (_inputs(), _inputs(seed=9, nan=True)):
            want = fn(*args).numpy()
            consts = (ctypes.c_float * model_trace.MAX_CONSTS)(*tr.consts)
            out = np.empty_like(want)
            ptr = [a.numpy().ctypes.data_as(ctypes.c_void_p) for a in args]
            getattr(dll, f"eval_{name}")(
                consts, *ptr, out.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_int(out.size))
            nan = np.isnan(want)
            np.testing.assert_array_equal(np.isnan(out), nan, err_msg=name)
            if nan.all():
                continue
            peak = np.abs(want[~nan]).max()
            err = np.abs(out[~nan] - want[~nan]).max()
            assert err <= 1e-5 * peak, (name, err, peak)

    def test_emitted_code_uses_no_fast_math(self, host_lib):
        text = host_lib[3]
        assert not re.search(r"__(cos|sin|exp|log|fdivide|powf|fsqrt)\w*\(",
                             text)
        # the constants are f32: no double literal or double libm call
        body = "\n".join(tr.body for tr in host_lib[1].values())
        assert not re.search(r"\b(exp|log|sqrt|cos|sin|pow)\(", body)
        decimal = re.sub(r"0x[0-9a-f.]+p[-+]\d+f", "", body)
        assert not re.search(r"\d\.\d*(e-?\d+)?(?![\df])",
                             decimal.replace("1.0f", "").replace("0.0f", ""))


class TestLibraryInterface:

    def test_model_entry_points_match_the_declared_signatures(self):
        text = (_build.CSRC / "march_model.cuh").read_text()
        kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
                 "float": ctypes.c_float}
        found = {}
        for m in re.finditer(r'extern "C"\s+(\w+)\s+(\w+)\(([^)]*)\)', text):
            args = []
            for p in m[3].split(","):
                decl = " ".join(p.replace("const", " ").split())
                args.append(ctypes.c_void_p if "*" in decl
                            else kinds[decl.rsplit(" ", 1)[0]])
            found[m[2]] = (None if m[1] == "void" else kinds[m[1]], args)
        assert set(found) == set(kernel_march.MODEL_SIGNATURES)
        for name, (argtypes, restype) in kernel_march.MODEL_SIGNATURES.items():
            assert found[name][0] is restype, name
            assert found[name][1] == argtypes, name

    def test_constant_capacity_matches_the_header(self):
        text = (_build.CSRC / "model.cuh").read_text()
        assert (f"constexpr int kModelConsts = {model_trace.MAX_CONSTS};"
                in text)

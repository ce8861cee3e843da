"""Any emissivity or absorption callable in the march kernel: the callable
traced into an elementwise op graph, and the graph emitted as a CUDA
functor.

The counterpart of what the JAX package does with `emissivity_fn` and
`absorption_fn`: `raytrace_pallas` traces the user's pure jnp callable
into the Pallas kernel's body (`_make_kernel`).  Here

* `trace_model(fn)` runs `torch.fx.experimental.proxy_tensor.make_fx` on
  four distinct f32 tensors (t, r, m, phi) and keeps the aten elementwise
  ops of `OPS`: the callable's op graph, in f32 as the kernel runs it.
  Every number the callable uses (Python floats, captured 0-dim tensors,
  fills) is lifted into one f32 array of at most `MAX_CONSTS` constants;
  the exponents of `pow` stay in the structure.  Models that differ only
  in their numbers (a flare at another time, another absorption
  coefficient) thus have one structure, one `key` and one emitted source,
  so one build serves them all;
* `evaluate(traced, t, r, m, phi)` runs the graph with torch ops: the
  plain form of what the kernel computes from the trace (bitwise the
  callable on the CPU);
* `emit_cuda(traced)` writes the graph as a C++ functor,
  `Model_<key>::operator()(const float* c, float t, float r, float m,
  float phi)`, with torch's semantics: IEEE libm calls (no fast-math
  intrinsics), NaN-propagating maximum / minimum / clamp, floored
  remainder, pow's special exponents as aten's pow kernel takes them, each
  constant as the f32 it is in torch.  `SIM5_HD` (csrc/model.cuh) makes it
  a device function under nvcc and plain C++ under g++;
* `march_source(emissivity, absorption)` is the translation unit of a
  march library for the pair: csrc/march.cuh's kernel instantiated with
  the emitted functors (csrc/march_model.cuh), which
  `kernel_march` builds with `_build.load_generated` at first use.

What cannot be traced into the kernel is refused with TypeError, naming
the model and the op or the reason, before anything is built or launched:
an op outside `OPS` (a reduction, indexing, a change of shape or of dtype
among them), data-dependent control flow (a Python branch on a tensor's
value, which make_fx cannot trace), a captured tensor that is not 0-dim,
more than `MAX_CONSTS` constants, or a result that is not one f32 value a
ray.  A captured tensor that requires grad raises ValueError: the kernel
is forward only.

A callable is traced anew on every call of an entry point
(`raytrace_kernel`, `volume_image`), as `raytrace_pallas` retraces its
callables on every call: the numbers it reads (a global, an attribute, a
captured tensor) are those of that call.  Only a model whose numbers
cannot change keeps its trace: a frozen dataclass of Python numbers, such
as `emission.GaussianSource`, cached by value, so equal ones share one.
A `TracedModel` is itself a model: calling it evaluates the trace, and
tracing it returns it as it is.
"""

import dataclasses
import functools
import hashlib

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

# the constants a model may lift (csrc/model.cuh: sim5::kModelConsts)
MAX_CONSTS = 32

# the rays of a trace: distinct inputs, so make_fx binds t, r, m and phi to
# four placeholders (one tensor for all four would bind them to one)
_TRACE_RAYS = 8

# C functions of one float operand
_UNARY_FN = {
    "exp": "expf", "log": "logf", "sqrt": "sqrtf", "cos": "cosf",
    "sin": "sinf", "tan": "tanf", "tanh": "tanhf", "sinh": "sinhf",
    "cosh": "coshf", "asin": "asinf", "acos": "acosf", "atan": "atanf",
    "abs": "fabsf", "floor": "floorf", "ceil": "ceilf", "trunc": "truncf",
    "round": "rintf", "expm1": "expm1f", "log1p": "log1pf", "log2": "log2f",
    "log10": "log10f", "exp2": "exp2f", "erf": "erff", "erfc": "erfcf",
}
# expressions of one or two operands {0}, {1}: torch's semantics
_EXPR = {
    "neg": "(-{0})",
    "rsqrt": "(1.0f / sqrtf({0}))",
    "reciprocal": "(1.0f / {0})",
    "sigmoid": "(1.0f / (1.0f + expf(-{0})))",
    "logical_not": "(!{0})",
    "bitwise_not": "(!{0})",
    "add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
    "div": "({0} / {1})", "rsub": "({1} - {0})",
    "atan2": "atan2f({0}, {1})", "pow": "powf({0}, {1})",
    "maximum": "sim5::nan_max({0}, {1})",
    "minimum": "sim5::nan_min({0}, {1})",
    "fmax": "fmaxf({0}, {1})", "fmin": "fminf({0}, {1})",
    "remainder": "sim5::floor_mod({0}, {1})", "fmod": "fmodf({0}, {1})",
    "gt": "({0} > {1})", "ge": "({0} >= {1})", "lt": "({0} < {1})",
    "le": "({0} <= {1})", "eq": "({0} == {1})", "ne": "({0} != {1})",
    "logical_and": "({0} && {1})", "logical_or": "({0} || {1})",
    "logical_xor": "(!{0} != !{1})",
    "bitwise_and": "({0} && {1})", "bitwise_or": "({0} || {1})",
    "bitwise_xor": "({0} != {1})",
    "where": "({0} ? {1} : {2})",
    "_to_copy": "{0}",
}
_EXPR.update({k: f"{fn}({{0}})" for k, fn in _UNARY_FN.items()})
# the overloads each op is taken in
_OVERLOADS = dict.fromkeys(_UNARY_FN, ("default",))
_OVERLOADS.update(dict.fromkeys(
    ("neg", "rsqrt", "reciprocal", "sigmoid", "logical_not", "bitwise_not",
     "atan2", "maximum", "minimum", "fmax", "fmin", "logical_and",
     "logical_or", "logical_xor", "_to_copy"), ("default",)))
# (a Python scalar operand comes as the .Tensor overload, or folded into
# a scalar_tensor constant before `where`)
_OVERLOADS.update(dict.fromkeys(
    ("add", "sub", "mul", "div", "bitwise_and", "bitwise_or",
     "bitwise_xor"), ("Tensor",)))
_OVERLOADS.update(dict.fromkeys(
    ("fmod", "gt", "ge", "lt", "le", "eq", "ne"), ("Tensor", "Scalar")))
_OVERLOADS.update(
    rsub=("Scalar",), where=("self",),
    pow=("Tensor_Scalar", "Tensor_Tensor", "Scalar"),
    remainder=("Tensor", "Scalar", "Scalar_Tensor"),
    clamp=("default", "Tensor"), clamp_min=("default", "Tensor"),
    clamp_max=("default", "Tensor"), full_like=("default",),
    zeros_like=("default",), ones_like=("default",))
# ops that pass their operand through: a captured or inline constant's
# copy, and detach / clone
_IDENTITY = {"lift_fresh_copy", "detach", "detach_", "clone", "alias"}
# keyword arguments an op may carry (fills and copies: their tensor
# options; add and sub: alpha = 1)
_KWARGS = {"dtype", "layout", "device", "pin_memory", "memory_format",
           "non_blocking"}

# the aten ops a model may use, by name
OPS = tuple(sorted(f"{name}.{ov}" for name, ovs in _OVERLOADS.items()
                   for ov in ovs))


@dataclasses.dataclass(frozen=True)
class TracedOp:
    """One op of a trace: the aten overload, its arguments as references
    (("v", i) the value i: 0-3 the inputs t, r, m, phi, 4 + k the result of
    op k; ("c", i) constant i as a Python float; ("t", i) constant i as a
    0-dim f32 tensor; ("lit", x) the literal x), its keyword arguments,
    its result's dtype, its C expression and its operations."""
    target: object
    args: tuple
    kwargs: dict
    dtype: torch.dtype
    expr: str
    flops: int


@dataclasses.dataclass(frozen=True)
class TracedModel:
    """A model traced for the kernel: `ops` in order, the reference `out`
    of the result, the lifted `consts` (f32), the structural `key` (a
    sha256 of the emitted body, which holds the ops and the exponents and
    not the constants' values), the emitted `body` and `flops`, the
    operations of one evaluation (each op one, pow's special forms their
    multiplies and divisions)."""
    name: str
    ops: tuple
    out: tuple
    consts: tuple
    key: str
    body: str
    flops: int

    def __call__(self, t, r, m, phi):
        return evaluate(self, t, r, m, phi)


def _name(fn):
    name = getattr(fn, "__qualname__", None)
    return name if isinstance(name, str) else repr(fn)[:80]


def trace_model(fn):
    """The `TracedModel` of the emissivity or absorption callable
    `fn(t, r, m, phi) -> tensor`, with the numbers it reads now; raises
    TypeError (or ValueError for a captured tensor that requires grad) for
    what the kernel cannot evaluate."""
    if isinstance(fn, TracedModel):
        return fn
    if _fixed(fn):
        return _trace_fixed(fn)
    return _trace(fn)


def _fixed(fn):
    """Whether fn's numbers cannot change: a frozen dataclass instance
    whose fields are Python numbers."""
    return (dataclasses.is_dataclass(fn) and not isinstance(fn, type)
            and fn.__dataclass_params__.frozen
            and all(type(getattr(fn, f.name)) in (bool, int, float)
                    for f in dataclasses.fields(fn)))


@functools.lru_cache(maxsize=256)
def _trace_fixed(fn):
    return _trace(fn)


def _trace(fn):
    name = _name(fn)
    base = torch.linspace(1.0, 2.0, _TRACE_RAYS)
    inputs = [base + 3.0 * i for i in range(4)]
    try:
        with torch.no_grad():
            gm = make_fx(fn)(*inputs)
            # the real value of every node, for constants folded here
            interp = torch.fx.Interpreter(gm, garbage_collect_values=False)
            interp.run(*inputs)
    except RuntimeError as e:
        if "_local_scalar_dense" in str(e):
            raise TypeError(
                f"model {name}: data-dependent control flow (a Python "
                "branch or number taken from a tensor's value) cannot be "
                "traced into the march kernel; use torch.where") from e
        raise TypeError(f"model {name} could not be traced: {e}") from e
    except Exception as e:
        raise TypeError(f"model {name} could not be traced: {e}") from e
    t = _Tracer(name, interp.env)
    for node in gm.graph.nodes:
        t.node(node, gm)
    return t.model()


class _Tracer:
    """Walks a make_fx graph into the ops, constants and emitted body of a
    `TracedModel`."""

    def __init__(self, name, env):
        self.name, self.env = name, env
        self.refs, self.ops, self.consts, self.dtypes = {}, [], [], {}
        self.out = None

    def refuse(self, why):
        raise TypeError(f"model {self.name}: {why}")

    def lift(self, value, kind):
        """("c" or "t", slot) of a new constant, its value's f32."""
        if isinstance(value, (bool, complex)):
            self.refuse(f"constant {value!r}")
        self.consts.append(float(np.float32(value)))
        if len(self.consts) > MAX_CONSTS:
            self.refuse(f"more than {MAX_CONSTS} constants")
        return (kind, len(self.consts) - 1)

    def arg(self, a):
        if isinstance(a, torch.fx.Node):
            return self.refs[a]
        if a is None:
            return ("lit", None)
        if isinstance(a, (int, float)) and not isinstance(a, bool):
            return self.lift(a, "c")
        self.refuse(f"argument {a!r}")

    def constant(self, c):
        """The reference of the captured or folded tensor constant c."""
        if c.requires_grad:
            raise ValueError(
                f"model {self.name} captures a tensor that requires grad: "
                "the march kernel is forward only; use engine='scan' for "
                "gradients")
        if c.dim() != 0 or c.is_complex():
            self.refuse(f"captured tensor of shape {tuple(c.shape)} and "
                        f"{c.dtype}: only 0-dim real tensors are constants")
        return self.lift(c.item(), "t")

    def node(self, node, gm):
        if node.op == "placeholder":
            ref = ("v", len(self.refs))
            self.refs[node] = ref
            self.dtypes[ref] = torch.float32
        elif node.op == "get_attr":
            self.refs[node] = self.constant(getattr(gm, node.target))
        elif node.op == "call_function":
            self.refs[node] = self.call(node)
        elif node.op == "output":
            out = node.args[0]
            val = self.env.get(out) if isinstance(out, torch.fx.Node) else out
            if (not isinstance(val, torch.Tensor) or self.refs[out][0] != "v"
                    or val.dtype != torch.float32
                    or tuple(val.shape) != (_TRACE_RAYS,)):
                self.refuse("returns " + (
                    f"{val.dtype} {tuple(val.shape)}"
                    if isinstance(val, torch.Tensor) else repr(val))
                    + ", not float32 of its inputs' shape")
            self.out = self.refs[out]
        else:
            self.refuse(f"graph node {node.op}")

    def call(self, node):
        """The reference of the value `node` computes, appending its op."""
        target = node.target
        packet = getattr(target, "_overloadpacket", None)
        name = getattr(packet, "__name__", str(target))
        overload = getattr(target, "_overloadname", "")
        if name in _IDENTITY:
            return self.arg(node.args[0])
        nodes = [a for a in node.args if isinstance(a, torch.fx.Node)]
        if all(self.refs[a][0] != "v" for a in nodes):
            # no ray value among its operands: folded here, in the dtype
            # the callable computed it in
            val = self.env[node]
            if not isinstance(val, torch.Tensor):
                self.refuse(f"op {name}.{overload} gives {val!r}")
            return self.constant(val)
        if overload not in _OVERLOADS.get(name, ()):
            self.refuse(f"op {name}.{overload} is not among the elementwise "
                        "ops of model_trace.OPS that the march kernel takes "
                        "(reductions, indexing and changes of shape or dtype "
                        "are not)")
        kwargs = dict(node.kwargs)
        if kwargs.pop("alpha", 1) != 1 or set(kwargs) - _KWARGS:
            self.refuse(f"op {name}.{overload} with {node.kwargs}")
        if kwargs.get("dtype") not in (None, torch.float32):
            self.refuse(f"op {name}.{overload} to {kwargs['dtype']}")
        val = self.env[node]
        if tuple(val.shape) != (_TRACE_RAYS,) or val.dtype not in (
                torch.float32, torch.bool):
            self.refuse(f"op {name}.{overload} gives {val.dtype} "
                        f"{tuple(val.shape)}, not float32 or bool of its "
                        "inputs' shape")
        args = [self.arg(a) for a in node.args]
        in_types = [self.dtypes[a] for a in args if a[0] == "v"]
        expr, flops = _EXPR.get(name), 1
        if name == "full_like":
            expr, flops = "{1}", 0
        elif name in ("zeros_like", "ones_like"):
            expr, flops = ("0.0f" if name == "zeros_like" else "1.0f"), 0
        elif name in ("clamp", "clamp_min", "clamp_max"):
            if name == "clamp":
                args += [("lit", None)] * (3 - len(args))
            bounds = {"clamp": ((1, "sim5::nan_max"), (2, "sim5::nan_min")),
                      "clamp_min": ((1, "sim5::nan_max"),),
                      "clamp_max": ((1, "sim5::nan_min"),)}[name]
            expr, flops = "{0}", 0
            for j, fn in bounds:
                if args[j] != ("lit", None):
                    expr, flops = f"{fn}({expr}, {{{j}}})", flops + 1
        elif name == "pow" and overload == "Tensor_Scalar":
            # aten's pow kernel takes these exponents in their own forms
            e = float(node.args[1])
            expr, flops = {
                2.0: ("({0} * {0})", 1), 3.0: ("({0} * {0} * {0})", 2),
                0.5: ("sqrtf({0})", 1), -0.5: ("(1.0f / sqrtf({0}))", 2),
                -1.0: ("(1.0f / {0})", 1), -2.0: ("(1.0f / ({0} * {0}))", 2),
            }.get(e, ("powf({0}, " + _f32_literal(e) + ")", 1))
            args = [args[0], ("lit", node.args[1])]
        elif name.startswith("bitwise") and any(
                t != torch.bool for t in in_types):
            self.refuse(f"op {name}.{overload} on non-bool tensors")
        elif name == "_to_copy" and any(
                t not in (torch.bool, torch.float32) for t in in_types):
            self.refuse(f"op {name} from {in_types}")
        self.ops.append(TracedOp(target=target, args=tuple(args),
                                 kwargs=node.kwargs, dtype=val.dtype,
                                 expr=expr, flops=flops))
        ref = ("v", 3 + len(self.ops))
        self.dtypes[ref] = val.dtype
        return ref

    def c_ref(self, ref, want_float):
        """The C operand of a reference; a bool cast to float where the op
        computes in float."""
        kind, i = ref
        if kind in ("c", "t"):
            return f"c[{i}]"
        if kind == "lit":
            return repr(i)
        text = ("t", "r", "m", "phi")[i] if i < 4 else f"v{i}"
        if want_float and self.dtypes[ref] == torch.bool:
            return f"static_cast<float>({text})"
        return text

    def model(self):
        lines = []
        for k, op in enumerate(self.ops):
            as_float = (op.dtype == torch.float32
                        and op.target._overloadpacket.__name__ != "where")
            operands = [self.c_ref(a, as_float or (op.dtype == torch.float32
                                                   and j > 0))
                        for j, a in enumerate(op.args)]
            ctype = "float" if op.dtype == torch.float32 else "bool"
            lines.append(f"    const {ctype} v{4 + k} = "
                         f"{op.expr.format(*operands)};")
        lines.append(f"    return {self.c_ref(self.out, True)};")
        body = "\n".join(lines)
        return TracedModel(
            name=self.name, ops=tuple(self.ops), out=self.out,
            consts=tuple(self.consts),
            key=hashlib.sha256(body.encode()).hexdigest()[:16], body=body,
            flops=sum(op.flops for op in self.ops))


def _f32_literal(x):
    """x as the C++ literal of its f32 value (hexadecimal, exact)."""
    return float(np.float32(x)).hex() + "f"


def evaluate(traced, t, r, m, phi):
    """The trace run with torch ops on f32 tensors t, r, m, phi of one
    shape: the plain form of what the kernel computes from it."""
    vals = [t, r, m, phi]
    dev = r.device

    def value(ref):
        kind, i = ref
        if kind == "v":
            return vals[i]
        if kind == "c":
            return traced.consts[i]
        if kind == "t":
            return torch.tensor(traced.consts[i], dtype=torch.float32,
                                device=dev)
        return i

    for op in traced.ops:
        kwargs = dict(op.kwargs)
        if "device" in kwargs:
            kwargs["device"] = dev
        vals.append(op.target(*[value(a) for a in op.args], **kwargs))
    return value(traced.out)


def emit_cuda(traced):
    """The C++ functor of a trace: `Model_<key>`, whose operator() takes
    the constants first."""
    return (f"struct Model_{traced.key} {{\n"
            "  SIM5_HD float operator()(const float* c, float t, float r,\n"
            "                           float m, float phi) const {\n"
            f"{traced.body}\n"
            "  }\n"
            "};\n")


def march_source(emissivity, absorption=None):
    """The translation unit of a march library for the traced emissivity
    and absorption (None: optically thin): csrc/march.cuh's kernel for the
    emitted functors, with csrc/march_model.cuh's entry points.  It holds
    the models' structure and not their constants, so models that differ
    only in their numbers share it."""
    models = {emissivity.key: emissivity}
    if absorption is not None:
        models.setdefault(absorption.key, absorption)
    ab = absorption or emissivity
    return ("// A march library for traced models, generated by\n"
            "// sim5_tpu_torch/march/model_trace.py (march_source).\n"
            '#include "march.cuh"\n\n'
            "namespace {\n\n"
            + "\n".join(emit_cuda(m) for m in models.values())
            + f"\nconstexpr int kModelRT = {1 if absorption is None else 2};\n"
            f"using ModelJ = sim5::Traced<Model_{emissivity.key}>;\n"
            f"using ModelA = sim5::Traced<Model_{ab.key}>;\n\n"
            "}  // namespace\n\n"
            '#include "march_model.cuh"\n')

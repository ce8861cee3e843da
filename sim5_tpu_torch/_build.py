"""Build the CUDA sources in `csrc/` into shared libraries, on first use.

Each library is compiled by `nvcc` for Hopper (sm_90a) into
`build/sim5_tpu_torch/` at the repository root, named by a hash of its
sources and flags, so an unchanged source is built once and reused.  The
library exposes a plain C interface and is loaded with `ctypes`; the
caller declares each function's signature.  The compiler's register and
spill report (`-Xptxas -v`) is kept beside the library as
`lib<name>_<hash>.log`.  `load_generated` builds a source that the port
writes at run time (a march library for traced emission models,
`march/model_trace.py`) under `build/sim5_tpu_torch/gen/`, against the
headers of `csrc/`.  `load_host` builds a host C++ source (the native IO
runtime, the analytic kernels' operation counter) the same way with g++.

No fast math: the kernels use the IEEE-accurate cosf, sqrtf and division.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "sim5_tpu_torch"
GEN_DIR = BUILD_DIR / "gen"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the host libraries (the native IO runtime, native/sim5io.cpp)
HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")

# name -> {"path", "log", "seconds", "cached"} of each library loaded in
# this process
BUILDS = {}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def load(name, extra_flags=(), source=None):
    """Build (if needed) and load `csrc/<source>.cu` (source: `name` unless
    given) as the ctypes library `name`, with `extra_flags` after
    NVCC_FLAGS (this library's own options)."""
    return _load(name, [_nvcc()], NVCC_FLAGS + tuple(extra_flags),
                 CSRC / f"{source or name}.cu", sorted(CSRC.glob("*.cuh")))


def load_generated(name, source):
    """Build (if needed) and load the CUDA text `source`, which includes
    headers of csrc/, as the ctypes library `name`: written to
    build/sim5_tpu_torch/gen/<name>.cu and compiled with -I csrc and
    NVCC_FLAGS into the same directory."""
    GEN_DIR.mkdir(parents=True, exist_ok=True)
    src = GEN_DIR / f"{name}.cu"
    if not src.exists() or src.read_text() != source:
        tmp = src.with_name(f"{src.name}.{os.getpid()}.tmp")
        tmp.write_text(source)
        os.replace(tmp, src)
    return _load(name, [_nvcc(), "-I", str(CSRC)], NVCC_FLAGS, src,
                 sorted(CSRC.glob("*.cuh")), GEN_DIR)


def load_host(name, src, compiler, headers=()):
    """Build (if needed) and load the C++ file `src` with the host compiler
    `compiler` (a path to g++) and HOST_FLAGS, as library `name`; the
    library's name hashes `headers` too (the files `src` includes)."""
    return _load(name, [compiler], HOST_FLAGS, pathlib.Path(src),
                 list(headers))


def _load(name, cmd, flags, src, headers, out_dir=BUILD_DIR):
    """Compile `src` by `cmd` + `flags` into `out_dir`, named by a hash of
    the flags, the source and `headers`, unless that library exists, and
    load it."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for p in [src] + list(headers):
        digest.update(p.read_bytes())
    lib_path = out_dir / f"lib{name}_{digest.hexdigest()[:16]}.so"
    log = lib_path.with_suffix(".log")
    t0 = time.perf_counter()
    cached = lib_path.exists()
    if not cached:
        out_dir.mkdir(parents=True, exist_ok=True)
        # build under a private name, then rename: concurrent builders
        # never load a half-written library
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [*cmd, *flags, "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed on {src}:\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    BUILDS[name] = {"path": str(lib_path), "log": str(log), "cached": cached,
                    "seconds": time.perf_counter() - t0}
    return lib

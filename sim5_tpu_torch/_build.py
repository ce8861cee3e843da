"""Build the CUDA sources in `csrc/` into shared libraries, on first use.

Each library is compiled by `nvcc` for Hopper (sm_90a) into
`build/sim5_tpu_torch/` at the repository root, named by a hash of its
sources and flags, so an unchanged source is built once and reused.  The
library exposes a plain C interface and is loaded with `ctypes`; the
caller declares each function's signature.  The compiler's register and
spill report (`-Xptxas -v`) is kept beside the library as
`lib<name>_<hash>.log`.

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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def load(name):
    """Build (if needed) and load `csrc/<name>.cu` as a ctypes library."""
    src = CSRC / f"{name}.cu"
    headers = sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src] + headers:
        digest.update(p.read_bytes())
    lib_path = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    log = lib_path.with_suffix(".log")
    t0 = time.perf_counter()
    cached = lib_path.exists()
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a private name, then rename: concurrent builders
        # never load a half-written library
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    BUILDS[name] = {"path": str(lib_path), "log": str(log), "cached": cached,
                    "seconds": time.perf_counter() - t0}
    return lib

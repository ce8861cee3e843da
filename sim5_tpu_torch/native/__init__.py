"""Native (C++) host runtime: an asynchronous checkpoint writer and CRC32.

Port of `sim5_tpu/native/__init__.py`.  The writer thread pool of the
repository's `native/sim5io.cpp` lets table and image-stack persistence
overlap the card's next rows or frames.  The library is built with g++ on
first use into `build/sim5_tpu_torch/libsim5io_<hash>.so` (`_build.py`'s
naming: a hash of the source and flags), never into `native/`, whose
`libsim5io.so` belongs to the JAX package.  Without g++ (or if the build
fails) every entry point is synchronous Python.  Which path was taken is
logged once.  This is host IO: no tensor and no kernel passes through it.
"""

import ctypes
import os
import shutil
import subprocess
import zlib

from .. import _build
from ..utils.log import get_logger, log_run

SOURCE = _build.CSRC.parent.parent / "native" / "sim5io.cpp"

# the loaded library, False once a load failed, None before the first try
_lib = None


def _declare(lib):
    lib.s5_writer_create.restype = ctypes.c_void_p
    lib.s5_writer_create.argtypes = [ctypes.c_int]
    lib.s5_writer_destroy.argtypes = [ctypes.c_void_p]
    lib.s5_writer_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_void_p, ctypes.c_uint64]
    lib.s5_writer_pending.restype = ctypes.c_int
    lib.s5_writer_pending.argtypes = [ctypes.c_void_p]
    lib.s5_writer_flush.argtypes = [ctypes.c_void_p]
    lib.s5_writer_bytes.restype = ctypes.c_uint64
    lib.s5_writer_bytes.argtypes = [ctypes.c_void_p]
    lib.s5_writer_errors.restype = ctypes.c_uint64
    lib.s5_writer_errors.argtypes = [ctypes.c_void_p]
    lib.s5_crc32.restype = ctypes.c_uint32
    lib.s5_crc32.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    gxx = shutil.which("g++")
    if gxx is None:
        _lib, reason = False, "no g++ on PATH"
    else:
        try:
            _lib = _declare(_build.load_host("sim5io", SOURCE, gxx))
            reason = None
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _lib, reason = False, f"build or load failed: {e}"
    if _lib:
        log_run(get_logger(), "native_io", path="native",
                library=_build.BUILDS["sim5io"]["path"])
    else:
        log_run(get_logger(), "native_io", path="synchronous python",
                reason=reason)
    return _lib


def native_available():
    return bool(_load())


def crc32(data: bytes) -> int:
    lib = _load()
    if lib:
        return int(lib.s5_crc32(data, len(data)))
    return zlib.crc32(data)


class AsyncWriter:
    """Background file writer (atomic tmp + rename); synchronous writes
    without the native library.

    Two snapshots of one path in flight can be renamed out of order
    (`native/sim5io.cpp:128`), so call `flush()` before a final
    synchronous save of that path (`checkpointed_frames` does).
    """

    def __init__(self, n_threads=2):
        lib = _load()
        self._lib = lib if lib else None
        self._h = lib.s5_writer_create(n_threads) if lib else None

    def submit(self, path: str, data: bytes):
        if self._h is not None:
            self._lib.s5_writer_submit(self._h, path.encode(), data, len(data))
        else:
            tmp = path + ".s5tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)

    def pending(self) -> int:
        if self._h is not None:
            return int(self._lib.s5_writer_pending(self._h))
        return 0

    def flush(self):
        if self._h is not None:
            self._lib.s5_writer_flush(self._h)

    @property
    def bytes_written(self):
        if self._h is not None:
            return int(self._lib.s5_writer_bytes(self._h))
        return 0

    @property
    def errors(self):
        if self._h is not None:
            return int(self._lib.s5_writer_errors(self._h))
        return 0

    def close(self):
        if self._h is not None:
            self._lib.s5_writer_flush(self._h)
            self._lib.s5_writer_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # interpreter shutdown may have torn the library down already
        try:
            self.close()
        except Exception:
            pass

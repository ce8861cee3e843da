"""The port's frame checkpoints (`sim5_tpu_torch.render.checkpoint`) and
native writer (`sim5_tpu_torch.native`), on the CPU.

* `FrameCheckpoint`: CRC, resume, files that the JAX package opens and the
  reverse.
* Kill and resume (`tests/test_checkpoint.py:66-124`): a child process
  that imports only `sim5_tpu_torch` renders a spin sweep of disk images
  through `checkpointed_frames`, is SIGKILLed mid-sweep, and the parent
  resumes it; the result is bitwise that of an uninterrupted run.
* `hotspot_lightcurve_checkpointed` at npix 24 against the JAX package's
  wrapper around the port's light curve: bitwise (the whole function
  against the JAX package's is in `test_torch_slow_parity.py`).
* `AsyncWriter`: round trip, `crc32 == zlib.crc32`, `save_async`, and the
  library built under `build/`, never in `native/`.
"""

import hashlib
import os
import pathlib
import signal
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from sim5_tpu.render import FrameCheckpoint as JFrameCheckpoint
from sim5_tpu.render import (hotspot_lightcurve_checkpointed
                             as j_hotspot_checkpointed)
from sim5_tpu_torch import native
from sim5_tpu_torch.render import (FrameCheckpoint, checkpointed_frames,
                                   hotspot_lightcurve_checkpointed)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SWEEP = 24          # frames of the killed sweep
NPIX = 64

# one frame of the sweep: a disk image at spin 0.99 - 0.02 i; it prints
# its index as it starts, after the frames before it were saved
FRAME = """
import numpy as np
import torch
from sim5_tpu_torch.disk import nt_setup
from sim5_tpu_torch.render import checkpointed_frames, render_disk_image

def frame(i):
    print(i, flush=True)
    disk = nt_setup(10.0, 0.99 - 0.02 * i, 0.1, 0.1, device="cpu")
    return render_disk_image(disk, np.radians(60.0), {npix}, {npix})[0]
""".format(npix=NPIX)

# the child imports only the port, and checks so
CHILD = """
import sys
sys.path.insert(0, {root!r})
{frame}
assert "jax" not in sys.modules and "sim5_tpu" not in sys.modules
torch.set_num_threads(2)
checkpointed_frames(sys.argv[1], frame, {n}, ({npix}, {npix}),
                    meta=dict(sweep="spin"))
""".format(root=str(ROOT), frame=FRAME, n=SWEEP, npix=NPIX)


def _sweep_frame(i, _ns={}):
    if not _ns:
        exec(FRAME, _ns)
    return _ns["frame"](i)


class TestFrameCheckpoint:
    def test_create_write_reopen_crc(self, tmp_path):
        p = str(tmp_path / "ck.npz")
        ck = FrameCheckpoint.create(p, 4, (3, 2))
        ck.write(1, torch.full((3, 2), 7.0))
        ck2 = FrameCheckpoint.open(p)
        assert ck2.progress == (1, 4) and ck2.pending() == [0, 2, 3]
        np.testing.assert_array_equal(ck2.frames[1], 7.0)
        # NaN inside a frame is data, not a pending marker
        ck2.write(2, np.full((3, 2), np.nan))
        assert FrameCheckpoint.open(p).progress == (2, 4)
        raw = bytearray(open(p, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(p, "wb").write(bytes(raw))
        with pytest.raises(Exception):
            FrameCheckpoint.open(p)

    def test_resume_and_meta(self, tmp_path):
        p = str(tmp_path / "ck.npz")
        calls = []

        def fn(i):
            calls.append(i)
            return torch.full((2,), float(i))

        meta = dict(a=torch.tensor(0.5), npix=np.int64(32))
        checkpointed_frames(p, fn, 5, (2,), meta=meta)
        assert calls == [0, 1, 2, 3, 4]
        calls.clear()
        ck = checkpointed_frames(p, fn, 5, (2,), meta=dict(a=0.5, npix=32))
        assert calls == [] and ck.progress == (5, 5)
        assert ck.meta == {"a": 0.5, "npix": 32}
        # other physics restarts the stack
        ck = checkpointed_frames(p, fn, 5, (2,), meta=dict(a=0.6, npix=32))
        assert calls == [0, 1, 2, 3, 4] and ck.progress == (5, 5)

    def test_files_interchange(self, tmp_path):
        p1, p2 = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
        FrameCheckpoint.create(p1, 3, (2,), meta=dict(k=1)).write(
            1, np.array([1.0, np.nan]))
        JFrameCheckpoint.create(p2, 3, (2,), meta=dict(k=1)).write(
            2, np.array([3.0, 4.0]))
        j = JFrameCheckpoint.create(p1, 3, (2,), meta=dict(k=1))
        t = FrameCheckpoint.create(p2, 3, (2,), meta=dict(k=1))
        assert j.pending() == [0, 2] and t.pending() == [0, 1]
        np.testing.assert_array_equal(j.frames[1], [1.0, np.nan])
        np.testing.assert_array_equal(t.frames[2], [3.0, 4.0])


class TestKillAndResume:
    def test_sigkill_mid_sweep_then_resume_bitwise(self, tmp_path, capsys):
        ckpath = str(tmp_path / "sweep.npz")
        src = tmp_path / "child.py"
        src.write_text(CHILD)
        proc = subprocess.Popen([sys.executable, "-u", str(src), ckpath],
                                stdout=subprocess.PIPE, text=True)
        try:
            # "k" is printed as frame k starts, after frames < k were saved
            for line in proc.stdout:
                if int(line) >= 3:
                    os.kill(proc.pid, signal.SIGKILL)
                    break
        finally:
            proc.kill()
            proc.wait(timeout=60)
        assert proc.returncode == -signal.SIGKILL
        done, total = FrameCheckpoint.open(ckpath).progress
        assert 3 <= done < total == SWEEP, "the kill landed mid-sweep"

        capsys.readouterr()
        resumed = checkpointed_frames(ckpath, _sweep_frame, SWEEP,
                                      (NPIX, NPIX), meta=dict(sweep="spin"))
        assert resumed.progress == (SWEEP, SWEEP)
        # only the missing frames were computed
        assert len(capsys.readouterr().out.split()) == SWEEP - done
        clean = checkpointed_frames(str(tmp_path / "clean.npz"),
                                    _sweep_frame, SWEEP, (NPIX, NPIX),
                                    meta=dict(sweep="spin"))
        assert np.array_equal(resumed.frames, clean.frames)
        assert np.isfinite(clean.frames).all() and clean.frames.max() > 0


class TestHotspotCheckpointed:
    def test_against_jax_wrapper(self, tmp_path, monkeypatch):
        """Two chunks of four times (the second padded) at npix 24: the JAX
        package's checkpointing wrapper run around the port's
        `hotspot_lightcurve` writes the port's checkpoint bit for bit (the
        same chunks, padding, frames and meta).  The JAX package's own
        light curve
        compiles for minutes on a CPU; the whole function against it is
        `test_torch_slow_parity.py`'s (outside tier-1)."""
        from sim5_tpu.render import lightcurve as jlc
        from sim5_tpu_torch.render import hotspot_lightcurve
        kw = dict(a=0.6, incl=np.radians(60.0), r_spot=8.0, spot_size=1.0,
                  t_obs=np.linspace(0.0, 500.0, 6), npix=24, n_orders=1,
                  chunk=4)
        calls = []

        def port_curve(*args, **kwargs):
            calls.append(len(args[4]))
            return hotspot_lightcurve(*args, device="cpu", **kwargs).numpy()

        monkeypatch.setattr(jlc, "hotspot_lightcurve", port_curve)
        jt, jcurve = j_hotspot_checkpointed(str(tmp_path / "j.npz"), **kw)
        assert calls == [4, 2]
        tt, lc = hotspot_lightcurve_checkpointed(str(tmp_path / "t.npz"),
                                                 device="cpu", **kw)
        assert isinstance(lc, np.ndarray) and lc.shape == (6,)
        np.testing.assert_array_equal(tt, jt)
        assert np.array_equal(lc, np.asarray(jcurve))
        ck = FrameCheckpoint.open(str(tmp_path / "t.npz"))
        jck = JFrameCheckpoint.open(str(tmp_path / "j.npz"))
        assert ck.meta == jck.meta and ck.progress == (2, 2)
        assert np.array_equal(ck.frames, jck.frames)
        assert (ck.frames[1, 2:] == 0.0).all() and (lc > 0.0).all()
        # resuming the finished checkpoint computes no chunk
        from sim5_tpu_torch.render import lightcurve as tlc

        def no_call(*args, **kwargs):
            raise AssertionError("a finished chunk was recomputed")

        monkeypatch.setattr(tlc, "hotspot_lightcurve", no_call)
        _, again = hotspot_lightcurve_checkpointed(str(tmp_path / "t.npz"),
                                                   device="cpu", **kw)
        assert np.array_equal(again, lc)


class TestNative:
    def test_library_under_build(self):
        tracked = ROOT / "native" / "libsim5io.so"
        before = hashlib.sha256(tracked.read_bytes()).hexdigest()
        assert native.native_available()
        from sim5_tpu_torch import _build
        path = pathlib.Path(_build.BUILDS["sim5io"]["path"])
        assert path.parent == _build.BUILD_DIR and path.exists()
        assert path.name.startswith("libsim5io_")
        assert hashlib.sha256(tracked.read_bytes()).hexdigest() == before

    def test_crc32(self):
        rng = np.random.default_rng(21)
        for n in (0, 1, 7, 4096, 100003):
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            assert native.crc32(data) == zlib.crc32(data)

    def test_writer_round_trip(self, tmp_path):
        blobs = {str(tmp_path / f"f{k}.bin"): os.urandom(1000 + 37 * k)
                 for k in range(16)}
        with native.AsyncWriter(n_threads=3) as w:
            for p, data in blobs.items():
                w.submit(p, data)
            w.flush()
            assert w.pending() == 0 and w.errors == 0
            assert w.bytes_written == sum(len(d) for d in blobs.values())
        for p, data in blobs.items():
            assert open(p, "rb").read() == data
        assert not [f for f in os.listdir(tmp_path) if ".s5tmp" in f]

    def test_save_async(self, tmp_path):
        """A checkpoint and a table flushed through the writer read back as
        those saved synchronously, and checkpointed_frames drains the
        writer before its final save."""
        from sim5_tpu_torch.tables import SpectralTable
        p = str(tmp_path / "ck.npz")
        with native.AsyncWriter() as w:
            ck = checkpointed_frames(p, lambda i: torch.full((3,), i + 0.5),
                                     6, (3,), writer=w)
            t = SpectralTable.create(str(tmp_path / "t.npz"), [("a", [0.0])],
                                     [1.0, 2.0])
            t.write(0, torch.tensor([3.0, 4.0]))
            t.save_async(w)
        back = FrameCheckpoint.open(p)
        assert back.progress == (6, 6)
        np.testing.assert_array_equal(back.frames, ck.frames)
        assert SpectralTable.open(t.path).progress == (1, 1)

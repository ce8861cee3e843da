"""Checkpoint/resume for long renders (image stacks, lightcurve sweeps).

Port of `sim5_tpu/render/checkpoint.py`, whose files it reads and writes.
The reference resumes only spectral tables (sim5fitstable.py:105-140);
this module generalizes the SpectralTable design (npz + JSON manifest +
CRC32 + atomic replace, tables/spectable.py) to stacks of arbitrary-shape
frames: a killed lightcurve sweep or image-stack job reopens its
checkpoint and continues from the first missing frame.  The finished
result is bitwise identical to an uninterrupted run, as long as each frame
is a pure function of its index computed by the same arithmetic: on the
card, a frame free of float atomics (the disk image and march kernels, and
torch's sums, reduce in a fixed order).  Frames come to the host as f64
numpy arrays (`utils.host`), whatever device computed them.

Frames may legitimately contain NaN (masked pixels), so completion is
tracked by an explicit `done` vector, not by NaN markers.
"""

import json
import os
import zlib

import numpy as np

from ..utils.host import host_f64, json_roundtrip as _json_roundtrip


class FrameCheckpoint:
    """Resumable stack of `n_frames` frames of fixed `frame_shape`."""

    def __init__(self, path, n_frames, frame_shape, frames=None, done=None,
                 meta=None):
        self.path = path
        self.n_frames = int(n_frames)
        self.frame_shape = tuple(int(s) for s in frame_shape)
        if frames is None:
            frames = np.zeros((self.n_frames,) + self.frame_shape,
                              np.float64)
        self.frames = host_f64(frames)
        if done is None:
            done = np.zeros(self.n_frames, bool)
        self.done = np.asarray(done, bool)
        self.meta = _json_roundtrip(meta)
        if (self.frames.shape != (self.n_frames,) + self.frame_shape
                or self.done.shape != (self.n_frames,)):
            raise ValueError(f"frames {self.frames.shape} and done "
                             f"{self.done.shape} for {self.n_frames} frames "
                             f"of {self.frame_shape}")

    @classmethod
    def create(cls, path, n_frames, frame_shape, meta=None,
               overwrite=False):
        """Create a new checkpoint, or re-open an existing compatible one
        to resume (unless overwrite=True).

        Compatibility includes `meta`: a checkpoint written for different
        physics (different spin, inclination, ...) is NOT silently
        resumed -- it is discarded and restarted fresh, with a logged
        warning (resuming it would return stale frames labeled with the
        new parameters).  Pass meta=None to skip the check.
        """
        if os.path.exists(path) and not overwrite:
            c = cls.open(path)
            shape_ok = (c.n_frames == int(n_frames)
                        and c.frame_shape == tuple(int(s)
                                                   for s in frame_shape))
            meta_ok = meta is None or c.meta == _json_roundtrip(meta)
            if shape_ok and meta_ok:
                return c
            if shape_ok and not meta_ok:
                from ..utils.log import get_logger, log_run
                log_run(get_logger(), "checkpoint_meta_mismatch_restart",
                        path=path, stored=c.meta,
                        requested=_json_roundtrip(meta))
        c = cls(path, n_frames, frame_shape, meta=meta)
        c.save()
        return c

    @classmethod
    def open(cls, path):
        """Open and CRC-verify an existing checkpoint."""
        with np.load(path) as z:
            manifest = json.loads(str(z["manifest"]))
            frames = z["frames"]
            done = z["done"]
        crc = zlib.crc32(np.ascontiguousarray(frames).tobytes())
        crc = zlib.crc32(np.ascontiguousarray(done).tobytes(), crc)
        if crc != manifest["crc32"]:
            raise IOError(f"{path}: CRC mismatch (corrupt checkpoint)")
        return cls(path, frames.shape[0], frames.shape[1:], frames, done,
                   manifest.get("meta"))

    def _serialize(self):
        import io
        crc = zlib.crc32(np.ascontiguousarray(self.frames).tobytes())
        crc = zlib.crc32(np.ascontiguousarray(self.done).tobytes(), crc)
        manifest = dict(crc32=crc, meta=self.meta)
        buf = io.BytesIO()
        np.savez(buf, manifest=json.dumps(manifest), frames=self.frames,
                 done=self.done)
        return buf.getvalue()

    def save(self):
        """Atomic persist (write-then-rename, like SpectralTable.save)."""
        tmp = self.path + ".tmp.npz"
        with open(tmp, "wb") as f:
            f.write(self._serialize())
        os.replace(tmp, self.path)

    def save_async(self, writer):
        """Persist via the native async IO runtime
        (sim5_tpu_torch.native.AsyncWriter) so checkpointing overlaps
        compute."""
        writer.submit(self.path, self._serialize())

    def pending(self):
        """Indices of frames still to compute."""
        return [i for i in range(self.n_frames) if not self.done[i]]

    def write(self, index, frame, flush=True):
        self.frames[index] = host_f64(frame)
        self.done[index] = True
        if flush:
            self.save()

    @property
    def progress(self):
        return int(self.done.sum()), self.n_frames


def checkpointed_frames(path, compute_fn, n_frames, frame_shape,
                        flush_every=1, meta=None, writer=None):
    """Compute (or RESUME) a stack of frames with checkpointing.

    `compute_fn(i)` -> array or tensor (on any device) of `frame_shape`
    must be a pure function of the frame index (so a resumed run
    reproduces an uninterrupted one bitwise).  Flushes every
    `flush_every` completed frames -- a killed job loses at most that
    much work.  `writer`: optional native AsyncWriter; flushes then
    overlap the next frame's compute.

    Returns the completed FrameCheckpoint.
    """
    ck = FrameCheckpoint.create(path, n_frames, frame_shape, meta=meta)
    n_new = 0
    for i in ck.pending():
        frame = compute_fn(i)
        n_new += 1
        flush = (n_new % flush_every == 0)
        if flush and writer is not None:
            ck.frames[i] = host_f64(frame)
            ck.done[i] = True
            ck.save_async(writer)
        else:
            ck.write(i, frame, flush=flush)
    if writer is not None:
        # drain in-flight async snapshots BEFORE the final synchronous
        # save: a late async rename landing after it would replace the
        # complete checkpoint with a stale partial one
        writer.flush()
    ck.save()
    return ck


def hotspot_lightcurve_checkpointed(path, a, incl, r_spot, spot_size,
                                    t_obs, npix=256, rmax=None, n_orders=2,
                                    chunk=8, flush_every=1, device=None):
    """`hotspot_lightcurve` over a long observer-time sweep with
    kill-and-resume checkpointing: the curve is computed in chunks of
    `chunk` times on `device` (the card unless the caller asks for the
    CPU), one `hotspot_lightcurve` call a chunk, each copied to the host
    and persisted as one frame.  Returns (t_obs, flux), numpy arrays.
    """
    from .lightcurve import hotspot_lightcurve

    t_obs = np.asarray(t_obs, np.float64)
    n_frames = (len(t_obs) + chunk - 1) // chunk

    def compute(i):
        ts = t_obs[i * chunk:(i + 1) * chunk]
        out = np.zeros(chunk)
        out[:len(ts)] = host_f64(
            hotspot_lightcurve(a, incl, r_spot, spot_size, ts, npix=npix,
                               rmax=rmax, n_orders=n_orders, device=device))
        return out

    ck = checkpointed_frames(path, compute, n_frames, (chunk,),
                             flush_every=flush_every,
                             meta=dict(a=float(a), incl=float(incl),
                                       r_spot=float(r_spot),
                                       spot_size=float(spot_size),
                                       npix=int(npix)))
    return t_obs, ck.frames.reshape(-1)[:len(t_obs)]

"""Gridded spectral tables with checkpoint/resume.

Port of `sim5_tpu/tables/spectable.py`, a copy on the host whose files
interchange with the JAX package's: the same npz keys (`manifest`,
`spectra`, `energies`, `param_<name>`), the same JSON manifest, the CRC32
over the C-contiguous f64 spectra, and the same bytes from `to_fits`.

A re-design of the reference's FITS spectral-table container
(python/sim5fitstable.py): a parameter grid (outer product of named axes),
an energy grid, and one spectrum per grid row.  Partially computed tables
re-open and `generator()` yields only the rows that still need computing
-- the reference's resume semantics (sim5fitstable.py:105-140).  Axes and
rows may be tensors on any device; they are stored as f64 numpy arrays,
and `meta` as plain JSON values (`utils.host`).
"""

import json
import os
import zlib

import numpy as np

from ..utils.host import host_f64, json_roundtrip


class SpectralTable:
    """Container for spectra on a parameter grid.

    params: list of (name, 1-D array) axes; rows iterate the outer product
    in C order (last axis fastest), matching the reference row ordering.
    """

    def __init__(self, path, params, energies, spectra=None, meta=None):
        self.path = path
        self.params = [(str(n), host_f64(v)) for n, v in params]
        self.energies = host_f64(energies)
        self.shape = tuple(len(v) for _, v in self.params)
        self.n_rows = int(np.prod(self.shape))
        if spectra is None:
            spectra = np.full((self.n_rows, len(self.energies)), np.nan)
        self.spectra = host_f64(spectra)
        self.meta = json_roundtrip(meta)
        if self.spectra.shape != (self.n_rows, len(self.energies)):
            raise ValueError(f"spectra of shape {self.spectra.shape}, not "
                             f"{(self.n_rows, len(self.energies))}")

    # -- construction / persistence -------------------------------------

    @classmethod
    def create(cls, path, params, energies, meta=None, overwrite=False):
        """Create a new table (or re-open an existing compatible one for
        resume, unless overwrite=True).  (reference: Sim5_FitsTable.__init__,
        sim5fitstable.py:20-60)

        Compatibility includes `meta` (physics parameters, fast/radres/
        angres generation settings): a grid whose meta differs is restarted
        fresh instead of silently resumed with stale rows.  Pass meta=None
        to skip the check.
        """
        if os.path.exists(path) and not overwrite:
            t = cls.open(path)
            same = (len(t.params) == len(params)
                    and all(n1 == str(n2) and np.array_equal(v1, host_f64(v2))
                            for (n1, v1), (n2, v2) in zip(t.params, params))
                    and np.array_equal(t.energies, host_f64(energies))
                    and (meta is None or t.meta == json_roundtrip(meta)))
            if same:
                return t
        t = cls(path, params, energies, meta=meta)
        t.save()
        return t

    @classmethod
    def open(cls, path):
        """Open an existing table, verifying CRC (reference:
        sim5fitstable.py:46-59)."""
        with np.load(path) as z:
            manifest = json.loads(str(z["manifest"]))
            spectra = z["spectra"]
            energies = z["energies"]
            par = [(n, z[f"param_{n}"]) for n in manifest["param_names"]]
        crc = zlib.crc32(np.ascontiguousarray(spectra).tobytes())
        if crc != manifest["crc32"]:
            raise IOError(f"{path}: CRC mismatch (corrupt table)")
        return cls(path, par, energies, spectra, manifest.get("meta"))

    def _serialize(self):
        import io
        manifest = dict(
            param_names=[n for n, _ in self.params],
            crc32=zlib.crc32(np.ascontiguousarray(self.spectra).tobytes()),
            meta=self.meta,
        )
        buf = io.BytesIO()
        np.savez(buf, manifest=json.dumps(manifest), spectra=self.spectra,
                 energies=self.energies,
                 **{f"param_{n}": v for n, v in self.params})
        return buf.getvalue()

    def save(self):
        """Atomically persist the table with a CRC stamp (reference 'flush',
        sim5fitstable.py:143-162)."""
        tmp = self.path + ".tmp.npz"
        with open(tmp, "wb") as f:
            f.write(self._serialize())
        os.replace(tmp, self.path)

    def save_async(self, writer):
        """Persist via the native async IO runtime
        (sim5_tpu_torch.native.AsyncWriter) so checkpointing overlaps with
        device compute."""
        writer.submit(self.path, self._serialize())

    # -- grid access -----------------------------------------------------

    def row_params(self, index):
        """Parameter values of grid row `index` (C order)."""
        idx = np.unravel_index(index, self.shape)
        return {n: v[i] for (n, v), i in zip(self.params, idx)}

    def is_computed(self, index):
        return bool(np.isfinite(self.spectra[index]).all())

    def generator(self, batch=1):
        """Yield (indices, list-of-param-dicts) for uncomputed rows only --
        grid jobs resume mid-sweep.  (reference: generator,
        sim5fitstable.py:105-140)"""
        pending = [i for i in range(self.n_rows) if not self.is_computed(i)]
        for i in range(0, len(pending), batch):
            chunk = pending[i:i + batch]
            yield chunk, [self.row_params(j) for j in chunk]

    def write(self, index, spectrum, flush=False):
        """Store one row; flush persists immediately.  (reference: write,
        sim5fitstable.py:143-151)"""
        self.spectra[index] = host_f64(spectrum)
        if flush:
            self.save()

    @property
    def progress(self):
        done = np.isfinite(self.spectra).all(1).sum()
        return int(done), self.n_rows

    # -- FITS interop (optional) ----------------------------------------
    #
    # The reference stores spectral grids in a FITS file with three HDUs
    # (python/sim5fitstable.py:61-99): a PrimaryHDU carrying an md5
    # checksum of the grid definition in header key 'CRC'
    # (sim5fitstable.py:33-39,66), a 'META' BinTableHDU with columns
    # NAME/N/GRID holding rows REF_MASS, REF_DIST, ENERGIES, then one row
    # per parameter grid (:69-88), and a 'SPECTRA' BinTableHDU with one
    # row per grid point whose first column doubles as the computed-row
    # marker (>0 == computed, the resume test at :120).  We emit and read
    # exactly that layout so tables are interchangeable with the
    # reference tooling.

    @staticmethod
    def _fits_crc(ref_mass, ref_dist, params, energies):
        """md5 grid checksum, reproducing sim5fitstable.py:33-39 (the
        reference hashes the str() of each value; it is python2 code, so
        here the same strings are utf-8 encoded)."""
        import hashlib
        m = hashlib.md5()
        m.update(str(ref_mass).encode())
        m.update(str(ref_dist).encode())
        for name, vals in params:
            m.update((str(name) + str(np.asarray(vals))).encode())
        for e in np.asarray(energies):
            m.update(str(e).encode())
        return m.hexdigest()

    def to_fits(self, path):
        """Export in the reference's FITS layout (CRC'd Primary + META +
        SPECTRA HDUs, sim5fitstable.py:61-99), via the port's pure-numpy
        FITS writer (sim5_tpu_torch.utils.fitsio).

        Pending (never-computed) rows are written with a zero marker so a
        reference-style resume loop (sim5fitstable.py:118-123) skips
        exactly the computed rows.
        """
        from ..utils import fitsio
        ref_mass = self.meta.get("bh_mass", 0.0)
        ref_dist = self.meta.get("bh_dist", 0.0)
        # hash what the file stores (UPPER names, f32 grids) so that the
        # checksum recomputed on import matches
        crc = self._fits_crc(
            np.float32(ref_mass), np.float32(ref_dist),
            [(n.upper(), v.astype(np.float32)) for n, v in self.params],
            self.energies.astype(np.float32))

        names = ["REF_MASS", "REF_DIST", "ENERGIES"] + \
            [n.upper() for n, _ in self.params]
        grids = [np.float32([ref_mass]), np.float32([ref_dist]),
                 self.energies.astype(np.float32)] + \
            [v.astype(np.float32) for _, v in self.params]
        meta = fitsio.BinTable("META", [
            fitsio.Column("NAME", "16A", names),
            fitsio.Column("N", "1J", [len(g) for g in grids]),
            fitsio.Column("GRID", "1PE", grids),
        ])

        ne = len(self.energies)
        computed = np.isfinite(self.spectra).all(axis=1)
        marker = computed.astype(np.float32)  # 0 == pending
        spec32 = np.where(computed[:, None], self.spectra,
                          0.0).astype(np.float32)
        spectra = fitsio.BinTable("SPECTRA", [
            fitsio.Column("mdot", "1E", marker),
            fitsio.Column("Iv_0", f"{ne}E", spec32),
            fitsio.Column("Iv_f", f"{ne}E", spec32),
        ])
        fitsio.write_fits(path, [meta, spectra], primary_header={"CRC": crc})

    @classmethod
    def from_fits(cls, fits_path, path=None, spectrum_column="Iv_0",
                  check_crc=True):
        """Import a reference-layout FITS table (sim5fitstable.py:46-99).

        Reconstructs the parameter axes and energy grid from the META HDU,
        verifies the Primary header 'CRC' checksum against the grid
        definition (the reference's reopen gate, sim5fitstable.py:53), and
        reads spectra from `spectrum_column` of the SPECTRA HDU.  Rows
        whose first SPECTRA column is <= 0 are treated as pending (NaN),
        matching the reference's resume marker (sim5fitstable.py:120), so
        `generator()` continues a partially computed reference table.

        `path` sets where subsequent save() calls go (defaults to the
        FITS path with a .npz suffix).
        """
        from ..utils import fitsio
        primary, tables = fitsio.read_fits(fits_path)
        if "META" not in tables or "SPECTRA" not in tables:
            raise IOError(f"{fits_path}: missing META/SPECTRA HDUs")
        meta_hdu, spec_hdu = tables["META"], tables["SPECTRA"]
        crc = primary.get("CRC")

        ref_mass = ref_dist = 0.0
        energies = None
        params = []
        for name, n, grid in zip(meta_hdu["NAME"], meta_hdu["N"],
                                 meta_hdu["GRID"]):
            name, n, grid = str(name), int(n), np.asarray(grid)
            if name == "REF_MASS":
                ref_mass = float(grid[0])
            elif name == "REF_DIST":
                ref_dist = float(grid[0])
            elif name == "ENERGIES":
                energies = np.float64(grid[:n])
            else:
                params.append((name.lower(), np.float64(grid[:n])))
        if energies is None:
            raise IOError(f"{fits_path}: META HDU has no ENERGIES row")
        if check_crc and crc is not None:
            expect = cls._fits_crc(
                np.float32(ref_mass), np.float32(ref_dist),
                [(n.upper(), np.float32(v)) for n, v in params],
                np.float32(energies))
            if crc != expect:
                raise IOError(f"{fits_path}: CRC mismatch "
                              "(grid definition differs)")
        marker = np.asarray(spec_hdu.columns[0].array, np.float64)
        spectra = np.asarray(spec_hdu[spectrum_column], np.float64)
        spectra = np.where(marker[:, None] > 0.0, spectra, np.nan)
        if path is None:
            path = os.path.splitext(fits_path)[0] + ".npz"
        return cls(path, params, energies, spectra,
                   meta=dict(bh_mass=ref_mass, bh_dist=ref_dist))

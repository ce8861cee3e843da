"""The port's spectral tables (`sim5_tpu_torch.tables`, `utils.fitsio`)
against `sim5_tpu.tables`, on the CPU: files that interchange both ways,
a table begun by one package and finished by the other, the FITS export
byte for byte, shards, fast rows and a polarized row.

Tolerances:
* rows of the two packages: 1e-10 relative on the bins above 1e-6 of the
  peak (`test_torch_driver.py`'s spectrum gate; the f64 driver agrees to
  1e-10);
* fast (f32) rows against f64 rows: 1e-5 relative there
  (`tests/test_tables.py`'s fast-table gate);
* a polarized row: I, Q and U within 1e-10 of I's peak
  (`test_torch_polarized.py`'s spectrum gate).
Grids are tiny (radres 2, angres 10; npix 32).
"""

import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from sim5_tpu.tables import SpectralTable as JTable
from sim5_tpu.tables import generate_disk_table as j_generate
from sim5_tpu.tables import generate_polarized_table as j_generate_pol
from sim5_tpu_torch.tables import (SpectralTable, generate_disk_table,
                                   generate_polarized_table, merge_shards,
                                   shard_path)
from sim5_tpu_torch.utils import fitsio

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
E = np.geomspace(0.5, 10.0, 8)
GRID = dict(spins=[0.3, 0.7], mdots=[0.1], incls=[60.0], energies=E,
            radres=2.0, angres=10.0)
AXES = [("a", [0.0, 0.5]), ("i", [30.0, 60.0, 80.0])]


def _rows_close(got, want, rtol):
    for g, w in zip(got, want):
        nz = w > 1e-6 * w.max()
        assert nz.sum() > 3
        np.testing.assert_allclose(g[nz], w[nz], rtol=rtol)


class TestSpectralTable:
    def test_create_write_reopen_resume(self, tmp_path):
        path = str(tmp_path / "t.npz")
        Et = torch.tensor(np.geomspace(0.1, 10, 16))
        # axes, rows and meta as tensors: stored as f64 numpy and JSON
        axes = [("a", torch.tensor([0.0, 0.5])), ("i", [30., 60., 80.])]
        t = SpectralTable.create(path, axes, Et,
                                 meta=dict(spin=torch.tensor(0.5)))
        assert t.n_rows == 6 and t.progress == (0, 6)
        assert t.meta == {"spin": 0.5}
        t.write(0, torch.ones(16), flush=True)
        t.write(3, 2 * np.ones(16), flush=True)
        t2 = SpectralTable.open(path)
        assert t2.progress == (2, 6)
        assert [i for chunk, _ in t2.generator() for i in chunk] == \
            [1, 2, 4, 5]
        assert t2.row_params(3) == {"a": 0.5, "i": 30.0}
        # the same grid and meta resume; another meta restarts
        t3 = SpectralTable.create(path, axes, Et,
                                  meta=dict(spin=np.float64(0.5)))
        assert t3.progress == (2, 6)
        t4 = SpectralTable.create(path, axes, Et, meta=dict(spin=0.6))
        assert t4.progress == (0, 6)

    def test_crc_detects_corruption(self, tmp_path):
        path = str(tmp_path / "t.npz")
        t = SpectralTable.create(path, [("a", [0.0])], np.linspace(1, 2, 4))
        t.write(0, np.arange(4.0), flush=True)
        raw = bytearray(open(path, "rb").read())
        raw[-10] ^= 0xFF
        open(path, "wb").write(bytes(raw))
        with pytest.raises(Exception):
            SpectralTable.open(path)
        # a manifest CRC that disagrees with the spectra is the port's
        # own IOError
        t = SpectralTable.create(path, [("a", [0.0])], np.linspace(1, 2, 4),
                                 overwrite=True)
        t.write(0, np.arange(4.0), flush=True)
        with np.load(path) as z:
            d = {k: z[k] for k in z.files}
        d["spectra"] = d["spectra"] + 1.0
        with open(path, "wb") as f:
            np.savez(f, **d)
        with pytest.raises(IOError, match="CRC mismatch"):
            SpectralTable.open(path)

    def test_files_interchange(self, tmp_path):
        """Each package opens and resumes the other's file: the same npz
        keys, manifest and CRC."""
        p1, p2 = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
        meta = dict(bh_mass=10.0, fast=False)
        t = SpectralTable.create(p1, AXES, E, meta=meta)
        t.write(2, np.linspace(1, 2, 8), flush=True)
        j = JTable.create(p2, AXES, E, meta=meta)
        j.write(4, np.linspace(3, 4, 8), flush=True)
        with np.load(p1) as z1, np.load(p2) as z2:
            assert sorted(z1.files) == sorted(z2.files)
            m1, m2 = (json.loads(str(z["manifest"])) for z in (z1, z2))
            assert sorted(m1) == sorted(m2)
            assert m1["param_names"] == m2["param_names"] == ["a", "i"]
            assert m1["meta"] == m2["meta"] == meta
            for m, z in ((m1, z1), (m2, z2)):
                assert m["crc32"] == zlib.crc32(
                    np.ascontiguousarray(z["spectra"]).tobytes())
        jo = JTable.create(p1, AXES, E, meta=meta)      # JAX resumes port's
        to = SpectralTable.create(p2, AXES, E, meta=meta)   # and the reverse
        assert jo.progress == to.progress == (1, 6)
        np.testing.assert_array_equal(jo.spectra[2], np.linspace(1, 2, 8))
        np.testing.assert_array_equal(to.spectra[4], np.linspace(3, 4, 8))
        assert jo.meta == to.meta == meta


class TestFits:
    def _pair(self, tmp_path):
        kw = dict(meta=dict(bh_mass=10.0, bh_dist=8.5))
        Et = np.geomspace(0.1, 10, 16)
        axes = [("spin", [0.0, 0.5]), ("incl", [30.0, 60.0, 80.0])]
        t = SpectralTable.create(str(tmp_path / "t.npz"), axes, Et, **kw)
        j = JTable.create(str(tmp_path / "j.npz"), axes, Et, **kw)
        for tab in (t, j):
            tab.write(0, np.linspace(1, 2, 16))
            tab.write(4, np.linspace(3, 4, 16))
        return t, j

    def test_to_fits_byte_identical(self, tmp_path):
        t, j = self._pair(tmp_path)
        t.to_fits(str(tmp_path / "t.fits"))
        j.to_fits(str(tmp_path / "j.fits"))
        a = open(tmp_path / "t.fits", "rb").read()
        assert len(a) % 2880 == 0
        assert a == open(tmp_path / "j.fits", "rb").read()

    def test_round_trip_and_crc_gate(self, tmp_path):
        t, j = self._pair(tmp_path)
        fp = str(tmp_path / "t.fits")
        t.to_fits(fp)
        for r in (SpectralTable.from_fits(fp), JTable.from_fits(fp)):
            assert [n for n, _ in r.params] == ["spin", "incl"]
            np.testing.assert_allclose(r.energies, t.energies, rtol=1e-6)
            assert r.meta["bh_mass"] == 10.0 and r.progress == (2, 6)
            np.testing.assert_allclose(r.spectra[4], t.spectra[4], rtol=1e-6)
            assert [i for c, _ in r.generator() for i in c] == [1, 2, 3, 5]
        # a tampered grid fails the CRC gate unless it is disabled
        primary, tables = fitsio.read_fits(fp)
        tables["META"]["GRID"][-1] = np.float32([30.0, 60.0, 85.0])
        fitsio.write_fits(fp, [tables["META"], tables["SPECTRA"]],
                          primary_header={"CRC": primary["CRC"]})
        with pytest.raises(IOError, match="CRC mismatch"):
            SpectralTable.from_fits(fp)
        r = SpectralTable.from_fits(fp, check_crc=False)
        np.testing.assert_allclose(r.params[1][1], [30.0, 60.0, 85.0])

    def test_bintable_round_trip(self, tmp_path):
        """`tests/test_tables.py`'s FITS-layer check, on the port's copy."""
        path = str(tmp_path / "x.fits")
        t = fitsio.BinTable("T1", [
            fitsio.Column("NAME", "8A", ["abc", "de"]),
            fitsio.Column("IDX", "1J", [3, -7]),
            fitsio.Column("VEC", "4E", np.arange(8.0).reshape(2, 4)),
            fitsio.Column("BIG", "2D", [[1e-300, np.pi], [2.5, -1e222]]),
            fitsio.Column("VAR", "1PE", [np.float32([1, 2, 3]),
                                         np.float32([9.5])]),
        ])
        fitsio.write_fits(path, [t], primary_header={"CRC": "deadbeef",
                                                     "NITER": 42})
        assert os.path.getsize(path) % 2880 == 0
        primary, tables = fitsio.read_fits(path)
        assert primary["CRC"] == "deadbeef" and primary["NITER"] == 42
        r = tables["T1"]
        assert list(r["NAME"]) == ["abc", "de"]
        assert list(r["IDX"]) == [3, -7]
        np.testing.assert_array_equal(r["BIG"],
                                      [[1e-300, np.pi], [2.5, -1e222]])
        np.testing.assert_array_equal(r["VAR"][1], [9.5])


class TestGenerate:
    """One JAX table of two rows is the reference for every port table."""

    @pytest.fixture(scope="class")
    def ref(self, tmp_path_factory):
        d = tmp_path_factory.mktemp("ref")
        path = str(d / "jax.npz")
        t = j_generate(path, **GRID)
        assert t.progress == (2, 2)
        return path, t.spectra.copy()

    def test_jax_begun_port_finished(self, ref, tmp_path):
        path = str(tmp_path / "t.npz")
        shutil.copy(ref[0], path)
        j = JTable.open(path)
        j.spectra[1] = np.nan
        j.save()
        t = generate_disk_table(path, device="cpu", **GRID)
        assert t.progress == (2, 2)
        np.testing.assert_array_equal(t.spectra[0], ref[1][0])  # kept
        _rows_close(t.spectra, ref[1], 1e-10)
        assert JTable.open(path).progress == (2, 2)

    def test_port_begun_jax_finished(self, ref, tmp_path):
        path = str(tmp_path / "t.npz")
        t = generate_disk_table(path, device="cpu", **GRID)
        _rows_close(t.spectra, ref[1], 1e-10)
        port_row = t.spectra[0].copy()
        t.spectra[1] = np.nan
        t.save()
        j = j_generate(path, **GRID)
        assert j.progress == (2, 2)
        np.testing.assert_array_equal(j.spectra[0], port_row)
        _rows_close(j.spectra, ref[1], 1e-10)

    def test_polarized_row(self, tmp_path):
        kw = dict(spins=[0.5], incls=[60.0], energies=E, npix=32)
        j = j_generate_pol(str(tmp_path / "j.npz"), **kw)
        t = generate_polarized_table(str(tmp_path / "t.npz"), device="cpu",
                                     **kw)
        assert t.meta == j.meta and t.progress == (1, 1)
        np.testing.assert_array_equal(t.energies, j.energies)
        peak = j.spectra[0][:len(E)].max()
        np.testing.assert_allclose(t.spectra[0], j.spectra[0], rtol=0,
                                   atol=1e-10 * peak)


class TestPortGenerate:
    def test_fast_rows_match_f64_rows(self, tmp_path):
        kw = dict(spins=[0.7], mdots=[0.1], incls=[60.0],
                  energies=np.geomspace(0.5, 8.0, 12), radres=1.0,
                  angres=10.0, device="cpu")
        t64 = generate_disk_table(str(tmp_path / "t64.npz"), **kw)
        t32 = generate_disk_table(str(tmp_path / "t32.npz"), fast=True, **kw)
        assert t32.meta["fast"] is True and t64.meta["fast"] is False
        a, b = t64.spectra[0], t32.spectra[0]
        nz = a > 1e-6 * a.max()
        assert (np.abs(b[nz] - a[nz]) / a[nz]).max() < 1e-5
        # a fast table is another table: the f64 grid does not resume it
        t = generate_disk_table(str(tmp_path / "t32.npz"), **kw)
        assert t.meta["fast"] is False
        np.testing.assert_array_equal(t.spectra, t64.spectra)

    def test_fast_rows_at_example_08_resolution(self, tmp_path):
        """Two rows of example 08's grid at its resolution (radres 0.5,
        angres 20, 64 energies over 0.1-30 keV) whose f32 rays reach
        radial turning points near the inner edge and the far field: with
        the reference's absolute 1e-8 snap of the radial potential, f32
        rounding loses them there (the a = 0.9 row 2.0e-2 off the f64 row;
        the JAX package's own fast row 3.5e-5 off, on a CPU), and with
        the f32 snap of `core.photon_momentum` both rows are within 1e-5."""
        kw = dict(spins=[0.0, 0.9], mdots=[0.1], incls=[75.0],
                  energies=np.geomspace(0.1, 30.0, 64), radres=0.5,
                  angres=20.0, device="cpu")
        t64 = generate_disk_table(str(tmp_path / "t64.npz"), **kw)
        t32 = generate_disk_table(str(tmp_path / "t32.npz"), fast=True, **kw)
        for a, b in zip(t64.spectra, t32.spectra):
            nz = a > 1e-6 * a.max()
            assert (np.abs(b[nz] - a[nz]) / a[nz]).max() < 1e-5

    def test_two_process_sharding(self, tmp_path):
        """Process 1 of 2, then process 0, which merges: the shards are
        disjoint, and the merged table is the single-process table."""
        single = generate_disk_table(str(tmp_path / "one.npz"), device="cpu",
                                     **GRID)
        path = str(tmp_path / "two.npz")
        t1 = generate_disk_table(path, process_id=1, num_processes=2,
                                 device="cpu", **GRID)
        assert t1.progress == (1, 2)
        merged = generate_disk_table(path, process_id=0, num_processes=2,
                                     device="cpu", **GRID)
        assert merged.path == path and merged.progress == (2, 2)
        np.testing.assert_array_equal(merged.spectra, single.spectra)
        done = [np.isfinite(SpectralTable.open(
            shard_path(path, k, 2)).spectra).all(1) for k in range(2)]
        assert not (done[0] & done[1]).any() and (done[0] | done[1]).all()
        axes = [("spin", GRID["spins"]), ("mdot", GRID["mdots"]),
                ("incl", GRID["incls"])]
        again = merge_shards(path, axes, E, cleanup=True)
        np.testing.assert_array_equal(again.spectra, single.spectra)
        assert not os.path.exists(shard_path(path, 0, 2))

    def test_sigkill_mid_grid_then_resume_bitwise(self, tmp_path, capsys):
        """A child process that imports only the port generates a 12-row
        grid, is SIGKILLed after it reported 2 saved rows, and the grid
        resumed here is bitwise the uninterrupted one."""
        grid = dict(spins=[0.0, 0.5, 0.9], mdots=[0.05, 0.1],
                    incls=[30.0, 75.0], radres=1.0, angres=10.0)
        path = str(tmp_path / "killed.npz")
        child = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
                 "import numpy as np; "
                 "from sim5_tpu_torch.tables import generate_disk_table; "
                 "assert 'jax' not in sys.modules; "
                 f"generate_disk_table({path!r}, energies=np.geomspace("
                 f"0.5, 10.0, 8), device='cpu', verbose=True, **{grid!r})")
        proc = subprocess.Popen([sys.executable, "-u", "-c", child],
                                stdout=subprocess.PIPE, text=True)
        rows = 0
        try:
            for line in proc.stdout:
                rows += line.startswith("[tables] row")
                if rows >= 2:
                    os.kill(proc.pid, signal.SIGKILL)
                    break
        finally:
            proc.kill()
            proc.wait(timeout=60)
        assert proc.returncode == -signal.SIGKILL
        done = SpectralTable.open(path).progress[0]
        assert 2 <= done < 12, "the kill landed mid-grid"
        capsys.readouterr()
        resumed = generate_disk_table(path, energies=E, device="cpu",
                                      verbose=True, **grid)
        assert capsys.readouterr().out.count("[tables] row") == 12 - done
        clean = generate_disk_table(str(tmp_path / "clean.npz"), energies=E,
                                    device="cpu", **grid)
        assert resumed.progress == (12, 12)
        assert np.array_equal(resumed.spectra, clean.spectra)

    def test_mesh_raises(self, tmp_path):
        with pytest.raises(ValueError, match="mesh"):
            generate_disk_table(str(tmp_path / "t.npz"), mesh=object(),
                                device="cpu", **GRID)

"""Every example of the PyTorch port (`examples/torch_*.py`) runs end to
end on the CPU at its tiny size (SIM5_FAST=1, device cpu), as
tests/test_examples.py runs the JAX package's: each as a subprocess,
whose printed numbers must be finite and not all zero, and whose files
must hold a finite, nonzero image or table.  (On the card the examples
run in chip_smoke.py phase 26.)  The marching examples, 07, 11 and 12,
run in test_torch_examples_march.py, which keeps each file near 30 s."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = sorted(p.name for p in (REPO / "examples").glob("torch_*.py"))
# each example's arguments before the device, and the files it writes
ARGS = {
    "torch_01_kerr_spacetime.py": ((), ()),
    "torch_04_disk_image.py": (("0.9", "60", "32"),
                               ("disk_image_flux.npy",)),
    "torch_05_disk_spectrum.py": (("0.7", "60"), ()),
    "torch_06_polarization_map.py": (("0.9", "70", "32"), ("stokes_I.npy",)),
    "torch_07_hotspot_lightcurve.py": (("0.5", "70", "7"), ()),
    "torch_08_spectral_table.py": (("tab.npz",), ()),
    "torch_09_black_hole_shadow.py": (("0.9", "70", "32"),
                                      ("shadow_0.9_70.0.npz",)),
    "torch_10_polarized_spectrum.py": (("0.9", "70"), ()),
    "torch_11_thick_volume_transfer.py": (("0.9", "70"), ()),
    "torch_12_checkpointed_survey.py": (("0.7", "60"), ()),
}


def run_example(name, tmp):
    args, _ = ARGS[name]
    env = dict(os.environ, SIM5_FAST="1", OMP_NUM_THREADS="2",
               TMPDIR=str(tmp))
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / name), *args, "cpu"],
        capture_output=True, timeout=600, cwd=str(tmp), env=env)
    assert out.returncode == 0, (name, out.stderr.decode()[-3000:])
    return out.stdout.decode(), out.stderr.decode()


def finite_numbers(stdout, name):
    """The printed numbers: some, all finite, not all zero (a renamed
    keyword or a default that zeroes the physics fails here)."""
    vals = [float(v) for v in re.findall(r"[-+]?\d+\.\d+e?[-+]?\d*",
                                         stdout)]
    assert vals, f"{name}: no numeric output"
    assert all(np.isfinite(vals)), f"{name}: non-finite numbers"
    assert any(v != 0 for v in vals), f"{name}: all-zero output"


# the examples whose time goes to marches, run in test_torch_examples_march
MARCHING = ("torch_07_hotspot_lightcurve.py",
            "torch_11_thick_volume_transfer.py",
            "torch_12_checkpointed_survey.py")


def test_every_example_is_listed():
    assert EXAMPLES == sorted(ARGS)


def check_example(name, tmp_path):
    stdout, stderr = run_example(name, tmp_path)
    if name == "torch_08_spectral_table.py":
        assert "1/1 rows" in stderr
        from sim5_tpu_torch.tables import SpectralTable
        spectra = SpectralTable.open(str(tmp_path / "tab.npz")).spectra
        assert np.isfinite(spectra).all() and spectra.max() > 0
    else:
        finite_numbers(stdout, name)
    for fname in ARGS[name][1]:
        f = np.load(tmp_path / fname)
        arr = f["flux"] if fname.endswith(".npz") else f
        assert np.isfinite(arr).all() and arr.max() > 0, fname
    if name == "torch_12_checkpointed_survey.py":
        assert "lightcurve checkpoint" in stderr
        assert "thick-disk image on 1 device(s)" in stderr


@pytest.mark.parametrize("name", sorted(set(ARGS) - set(MARCHING)))
def test_example_runs(name, tmp_path):
    check_example(name, tmp_path)

"""Concurrent processes through the port's parallel layer, the counterpart
of tests/test_multiprocess.py: two gloo processes join one group by
`init_distributed(device="cpu")` on a file store and write disjoint
shards of a spectral table at the same time; the merged table is bitwise
a single-process run's.  Then four processes lay out rows across two
process ids and rays across each id's two ranks (a (2, 2) mesh whose
"rays" dim is passed as `mesh=`): the merged table agrees with the
single-process one to the rays' summation order."""

import pathlib
import sys

import numpy as np

from sim5_tpu_torch.tables import generate_disk_table, merge_shards

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_parallel_worker as worker  # noqa: E402

T = worker.MULTI_TABLE
PARAMS = [("spin", T["spins"]), ("mdot", T["mdots"]), ("incl", T["incls"])]


def single(path):
    return generate_disk_table(
        str(path), spins=T["spins"], mdots=T["mdots"], incls=T["incls"],
        energies=np.asarray(T["E"]), radres=T["radres"],
        angres=T["angres"], device="cpu")


class TestProcesses:
    def test_two_process_table_generation(self, tmp_path):
        worker.run_world("table", 2, tmp_path)
        shards = sorted(p.name for p in tmp_path.glob("multi.shard*.npz"))
        assert shards == ["multi.shard0of2.npz", "multi.shard1of2.npz"]
        merged = merge_shards(str(tmp_path / "multi.npz"), PARAMS,
                              np.asarray(T["E"]), num_processes=2)
        assert np.isfinite(merged.spectra).all(), "merged table has holes"
        want = single(tmp_path / "single.npz")
        np.testing.assert_array_equal(merged.spectra, want.spectra)

    def test_rows_across_processes_rays_across_ranks(self, tmp_path):
        worker.run_world("table_mesh", 4, tmp_path)
        merged = merge_shards(str(tmp_path / "multi_mesh.npz"), PARAMS,
                              np.asarray(T["E"]), num_processes=2)
        assert np.isfinite(merged.spectra).all(), "merged table has holes"
        want = single(tmp_path / "single.npz")
        np.testing.assert_allclose(merged.spectra, want.spectra, rtol=1e-10)

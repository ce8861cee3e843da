"""Spectral-grid generation drivers (BASELINE config #5 pattern).

Port of `sim5_tpu/tables/generate.py`.  Sweeps a (spin, mdot, inclination)
grid, raytraces the disk spectrum of each grid point with `DiskRaytrace`
on a device (the card unless the caller asks for the CPU), and stores the
rows in a resumable `SpectralTable`, row by row.

Several processes: each computes the rows whose index is congruent to its
process id and persists them to its own shard file
(``<path>.shardKofN.npz``), so concurrent processes never write the same
file; `merge_shards` combines the shards into the final table.  A
restarted process reopens its shard and skips the rows already computed
(the reference's resume semantics, python/sim5fitstable.py:105-140).
With `mesh=`, the rays of each row are also sharded over the mesh's
ranks (`DiskRaytrace.spectrum(mesh=)`): the mesh's rank 0 owns the
table and writes its rows, and the other ranks trace their share of the
same rows.
"""

import glob
import os
import re

import numpy as np
import torch

from .spectable import SpectralTable
from ..core.metric import default_device
from ..disk import ThinDisk, nt_setup
from ..render import DiskRaytrace, DiskSpectrum_BlackBody, polarized_spectrum
from ..utils.host import host_f64


def shard_path(path, process_id, num_processes):
    """Per-process table filename; the unsharded path for a single process."""
    if num_processes <= 1:
        return path
    base = path[:-4] if path.endswith(".npz") else path
    return f"{base}.shard{process_id}of{num_processes}.npz"


def merge_shards(path, params, energies, meta=None, num_processes=None,
                 cleanup=False):
    """Combine per-process shard tables into the final table at `path`.

    Takes every computed (all-finite) row from each shard; row ownership is
    disjoint by construction (index mod num_processes), so no row can be
    written by two shards.  Returns the merged SpectralTable (saved).
    With num_processes=None, shards are discovered by filename glob.
    """
    base = path[:-4] if path.endswith(".npz") else path
    if num_processes is None:
        pat = re.compile(re.escape(os.path.basename(base))
                         + r"\.shard(\d+)of(\d+)\.npz$")
        shards = [p for p in sorted(glob.glob(base + ".shard*of*.npz"))
                  if pat.match(os.path.basename(p))]
    else:
        shards = [shard_path(path, pid, num_processes)
                  for pid in range(num_processes)]
    merged = SpectralTable.create(path, params, energies, meta=meta)
    for sp in shards:
        if not os.path.exists(sp):
            continue
        t = SpectralTable.open(sp)
        done = np.isfinite(t.spectra).all(axis=1)
        merged.spectra[done] = t.spectra[done]
    merged.save()
    if cleanup:
        for sp in shards:
            if os.path.exists(sp):
                os.remove(sp)
    return merged


def generate_disk_table(path, spins, mdots, incls, energies,
                        bh_mass=10.0, bh_dist=10.0, radres=0.3, angres=30.0,
                        process_id=0, num_processes=1, flush_every=1,
                        merge=True, verbose=False, mesh=None, fast=False,
                        device=None):
    """Generate (or resume) a table of observed disk spectra.

    Grid axes: spin, mdot, incl [deg]; spectra on `energies` [keV].
    With num_processes > 1 this process computes and persists only its own
    row subset (see module docstring); merge=True (default) has process 0
    merge all shards present on its filesystem at the end.  Returns this
    process's SpectralTable (the merged table on the merging process).

    Each row is one `DiskRaytrace.spectrum` on `device` (the card unless
    the caller asks for the CPU).  `fast=True` computes rows in f32 (an f32
    disk and `DiskRaytrace(dtype=torch.float32)`, the JAX package's
    `enable_x64(False)`); stored spectra are f64 either way, and the mode
    is recorded in `meta["fast"]`.

    `mesh` (optional 1-D DeviceMesh, `parallel.make_mesh`): shard each
    row's rays over the mesh's ranks (`DiskRaytrace.spectrum(mesh=)`),
    each on its own card.  Every rank of the mesh calls this function
    with the same arguments; the mesh's rank 0 owns the table (creates,
    resumes, writes and saves it) and sends the other ranks the rows to
    compute; they return the saved table.  Combined with num_processes,
    rows are spread across processes and rays across the mesh: there the
    mesh is the sub-group of this process's local ranks (all of them
    with one process_id), e.g. `init_device_mesh("cuda", (hosts, cards),
    mesh_dim_names=("hosts", "rays"))["rays"]`.
    """
    dev = default_device(device)
    dtype = torch.float32 if fast else torch.float64
    params = [("spin", spins), ("mdot", mdots), ("incl", incls)]
    meta = dict(bh_mass=bh_mass, bh_dist=bh_dist, radres=radres,
                angres=angres, fast=bool(fast))
    if mesh is not None:
        from ..parallel.mesh import check_mesh
        check_mesh(mesh)
    spath = shard_path(path, process_id, num_processes)
    lead = mesh is None or mesh.get_local_rank() == 0
    todo, table = None, None
    if lead:
        table = SpectralTable.create(spath, params, energies, meta=meta)
        todo = [(indices[0], rowpars[0])
                for indices, rowpars in table.generator()
                if indices[0] % num_processes == process_id]
    if mesh is not None and mesh.size() > 1:
        todo = _from_lead(todo, mesh)
    n_written = 0
    for idx, p in todo:
        disk = ThinDisk.create(
            torch.tensor(float(bh_mass), dtype=dtype, device=dev),
            float(p["spin"]), float(p["mdot"]))
        rt = DiskRaytrace(float(bh_mass), float(p["spin"]), float(bh_dist),
                          disk, DiskSpectrum_BlackBody(), device=dev,
                          dtype=dtype)
        spec, _ = rt.spectrum(float(p["incl"]), host_f64(energies),
                              radres=radres, angres=angres, mesh=mesh)
        if not lead:
            continue
        n_written += 1
        table.write(idx, spec, flush=(n_written % flush_every == 0))
        if verbose:
            done, total = table.progress
            print(f"[tables] row {idx} done ({done}/{total})")
    if lead:
        table.save()
    if mesh is not None and mesh.size() > 1:
        torch.distributed.barrier(group=mesh.get_group())
    if not lead:
        return SpectralTable.open(spath)
    if num_processes > 1 and merge and process_id == 0:
        return merge_shards(path, params, energies, meta=meta,
                            num_processes=num_processes)
    return table


def _from_lead(obj, mesh):
    """`obj` of the mesh's rank 0, on every rank of the mesh."""
    group = mesh.get_group()
    box = [obj]
    torch.distributed.broadcast_object_list(
        box, src=torch.distributed.get_global_rank(group, 0), group=group)
    return box[0]


def generate_polarized_table(path, spins, incls, energies, bh_mass=10.0,
                             bh_dist=10.0, mdot=0.1, npix=128,
                             flush_every=1, verbose=False, device=None):
    """Generate (or resume) a table of Stokes-resolved disk spectra.

    Each row stores the concatenation [I_E, Q_E, U_E] (3 * len(energies)
    values) from `render.polarized_spectrum` of an NT disk on `device`
    (the card unless the caller asks for the CPU).  The row layout is
    recorded in the table meta (`stokes_layout`), and the CRC/resume
    semantics are those of SpectralTable.
    """
    dev = default_device(device)
    params = [("spin", spins), ("incl", incls)]
    energies = host_f64(energies)
    ncol = np.concatenate([energies, energies, energies])
    meta = dict(bh_mass=bh_mass, bh_dist=bh_dist, mdot=mdot, npix=npix,
                stokes_layout="I,Q,U x len(energies)")
    table = SpectralTable.create(path, params, ncol, meta=meta)
    n_written = 0
    for (indices, rowpars) in table.generator():
        idx = indices[0]
        p = rowpars[0]
        disk = nt_setup(bh_mass, float(p["spin"]), mdot, 0.1, device=dev)
        I, Q, U = polarized_spectrum(
            disk, float(np.radians(p["incl"])), energies, npix=npix,
            bh_mass=bh_mass, bh_dist=bh_dist)
        row = torch.cat([I, Q, U])
        n_written += 1
        table.write(idx, row, flush=(n_written % flush_every == 0))
        if verbose:
            done, total = table.progress
            print(f"[tables] polarized row {idx} done ({done}/{total})")
    table.save()
    return table

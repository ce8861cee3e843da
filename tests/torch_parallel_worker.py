"""One rank of a gloo world on the CPU for the port's parallel tests.

    python tests/torch_parallel_worker.py CASE RANK WORLD INIT_FILE OUT_DIR

joins a world of WORLD processes through the file store INIT_FILE (the
launcher cases: through the variables a launcher sets, `launcher_env`),
runs CASE's cases through `sim5_tpu_torch.parallel` on the CPU, writes
what the tests compare to OUT_DIR/CASE.rank<RANK>.npz, and destroys its
group.
It imports torch and the port only (no JAX), so that each rank starts in
a few seconds; `run_world` starts the ranks and waits for them.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent

# the sizes of the cases: none divides by the 3-rank world, so every
# sharded path pads
IMAGE = dict(M=10.0, a=0.7, mdot=0.1, alpha=0.1, incl=1.2, npix=32,
             rmax=12.0)
DRIVER = dict(M=10.0, a=0.7, dist=10.0, mdot=0.1, incl=60.0, rmax=15.0,
              N=20)
SPECTRUM = dict(E=(0.5, 8.0, 16), radres=0.6, angres=12.0, batch=301)
TABLE = dict(spins=[0.5], mdots=[0.1], incls=[45.0], E=(1.0, 6.0, 8),
             radres=0.8, angres=10.0)
FIT = dict(npix=16, lr=3e-3, steps=3, true=(10.0, 0.7, 0.1), incl=1.2,
           p3=(10.0, 0.65, 0.12), p4=(10.0, 0.68, 0.11, 1.15))
MULTI_TABLE = dict(spins=[0.5, 0.9], mdots=[0.1], incls=[45.0],
                   E=(1.0, 2.0, 4.0, 6.0), radres=1.0, angres=8.0)


def geom(spec):
    return np.geomspace(*spec)


def case_sharded(mesh, rank, out):
    """shard_image_rows, render_disk_image_sharded, DiskRaytrace.image and
    .spectrum with mesh=, and a table row through generate_disk_table."""
    import torch
    from sim5_tpu_torch.disk import ThinDisk
    from sim5_tpu_torch.parallel import (gather_rows,
                                         render_disk_image_sharded,
                                         shard_image_rows)
    from sim5_tpu_torch.render import DiskRaytrace, DiskSpectrum_BlackBody
    from sim5_tpu_torch.tables import generate_disk_table

    arr = torch.arange(20 * 16, dtype=torch.float64).reshape(20, 16)
    local = shard_image_rows(arr, mesh)
    out["shard"] = local.numpy()
    out["gathered"] = gather_rows(local, mesh, 20).numpy()
    c = IMAGE
    f, g = render_disk_image_sharded(mesh, c["M"], c["a"], c["mdot"],
                                     c["alpha"], c["incl"], c["npix"],
                                     c["npix"], rmax=c["rmax"])
    out["image_f"], out["image_g"] = f.numpy(), g.numpy()
    d = DRIVER
    disk = ThinDisk.create(d["M"], d["a"], d["mdot"], device="cpu")
    rt = DiskRaytrace(d["M"], d["a"], d["dist"], disk,
                      DiskSpectrum_BlackBody(), device="cpu")
    for k, v in rt.image(d["incl"], d["rmax"], d["N"], mesh=mesh).items():
        out[f"map_{k}"] = v.numpy()
    s = SPECTRUM
    sf, s0, diag = rt.spectrum(d["incl"], geom(s["E"]), radres=s["radres"],
                               angres=s["angres"], batch=s["batch"],
                               return_diagnostics=True, mesh=mesh)
    out["spec_f"], out["spec_0"] = sf.numpy(), s0.numpy()
    out["domega"] = np.array([diag["domega_err"], diag["domega_tot"]])
    t = TABLE
    path = os.path.join(os.environ["SIM5_WORKER_TMP"], "tab.npz")
    tab = generate_disk_table(path, spins=t["spins"], mdots=t["mdots"],
                              incls=t["incls"], energies=geom(t["E"]),
                              radres=t["radres"], angres=t["angres"],
                              mesh=mesh, device="cpu")
    out["table"] = tab.spectra


def case_fit(mesh, rank, out):
    """FIT["steps"] steps of fit_step_sharded with and without incl, and
    one step carried on from the JAX package's Adam state (carry.npz)."""
    from sim5_tpu_torch.parallel import (adam_state_from_numpy,
                                         fit_step_sharded)
    c = FIT
    n = c["npix"]
    target = np.load(os.path.join(os.environ["SIM5_WORKER_TMP"],
                                  "target.npy"))
    for tag, p0, incl in (("p3", c["p3"], c["incl"]), ("p4", c["p4"], None)):
        p, st, losses, params = p0, None, [], []
        for _ in range(c["steps"]):
            p, loss, st = fit_step_sharded(mesh, p, target, incl, n, n,
                                           lr=c["lr"], opt_state=st)
            losses.append(float(loss))
            params.append(p.numpy())
        out[f"{tag}_losses"] = np.array(losses)
        out[f"{tag}_params"] = np.array(params)
        out[f"{tag}_rmax"] = np.array(st[1])
    carry = np.load(os.path.join(os.environ["SIM5_WORKER_TMP"],
                                 "carry.npz"))
    st = adam_state_from_numpy(carry["count"], carry["mu"], carry["nu"],
                               carry["rmax"], device="cpu")
    p, loss, _ = fit_step_sharded(mesh, carry["params"], target, c["incl"],
                                  n, n, lr=c["lr"], opt_state=st)
    out["carry_params"], out["carry_loss"] = p.numpy(), np.array(float(loss))


def case_table(mesh, rank, out, world):
    """init_distributed over the file store, then this process's shard of
    MULTI_TABLE (rows index % world == rank), written concurrently."""
    t = MULTI_TABLE
    from sim5_tpu_torch.tables import generate_disk_table
    path = os.path.join(os.environ["SIM5_WORKER_TMP"], "multi.npz")
    generate_disk_table(path, spins=t["spins"], mdots=t["mdots"],
                        incls=t["incls"], energies=np.asarray(t["E"]),
                        radres=t["radres"], angres=t["angres"],
                        process_id=rank, num_processes=world, merge=False,
                        device="cpu")


def case_table_mesh(mesh, rank, out, world):
    """Rows across two processes and rays across each process's two ranks:
    a (2, 2) mesh, its "rays" dim the sub-group of one process id."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from sim5_tpu_torch.tables import generate_disk_table
    t = MULTI_TABLE
    hosts = world // 2
    grid = init_device_mesh("cpu", (hosts, 2),
                            mesh_dim_names=("hosts", "rays"))
    path = os.path.join(os.environ["SIM5_WORKER_TMP"], "multi_mesh.npz")
    generate_disk_table(path, spins=t["spins"], mdots=t["mdots"],
                        incls=t["incls"], energies=np.asarray(t["E"]),
                        radres=t["radres"], angres=t["angres"],
                        process_id=dist.get_rank() // 2,
                        num_processes=hosts, merge=False,
                        mesh=grid["rays"], device="cpu")


def case_launcher(mesh, rank, out):
    """The world as a launcher starts it: make_mesh (after
    init_distributed() with no arguments where the case asks for it)
    joins it from the environment alone; the mesh's size and this rank,
    and an all-reduce over it."""
    import torch
    import torch.distributed as dist
    from sim5_tpu_torch.parallel.mesh import all_reduce
    out["size"] = np.array([mesh.size(), dist.get_world_size()])
    out["rank"] = np.array([mesh.get_local_rank(), dist.get_rank()])
    out["sum"] = all_reduce(torch.ones(1) * (rank + 1), mesh).numpy()


def main(argv):
    case, rank, world, init_file, out_dir = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, str(REPO))
    import torch.distributed as dist
    from sim5_tpu_torch.parallel import init_distributed, make_mesh
    if case == "launcher_init":
        init_distributed(device="cpu")
    elif case != "launcher_mesh":
        init_distributed(f"file://{init_file}", world, rank, device="cpu")
    out = {}
    try:
        if case in ("table", "table_mesh"):
            globals()[f"case_{case}"](None, rank, out, world)
        else:
            run = case_launcher if case.startswith("launcher") else \
                globals()[f"case_{case}"]
            run(make_mesh(device="cpu"), rank, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"{case}.rank{rank}.npz"), **out)
    return 0


def launcher_env(rank, world, port):
    """The variables `torchrun` gives rank `rank` of a world of `world` on
    this host, its store on localhost:`port`."""
    return dict(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                MASTER_PORT=str(port))


def free_port():
    """A TCP port on localhost that no process holds now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(case, world, tmp, timeout=240, launcher=False):
    """Run CASE in a gloo world of `world` processes of this script, their
    group on a file store under `tmp` (which they also use for their
    files), or with `launcher`, on the variables a launcher sets
    (`launcher_env`, a store on a free localhost port); returns each
    rank's arrays, or fails with the ranks' output."""
    tmp = pathlib.Path(tmp)
    init = tmp / f"{case}.store"
    env = dict(os.environ, SIM5_WORKER_TMP=str(tmp), OMP_NUM_THREADS="1")
    port = free_port() if launcher else None
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(r), str(world), str(init),
         str(tmp)], env=dict(env, **(launcher_env(r, world, port)
                                     if launcher else {})),
        cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * world, "\n".join(
        f"--- rank {r} rc {rc}\n{log[-3000:]}"
        for r, (rc, log) in enumerate(zip(rcs, logs)))
    return [dict(np.load(tmp / f"{case}.rank{r}.npz")) for r in range(world)]


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

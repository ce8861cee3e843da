"""Data parallelism over GPUs: pixel rows and rays sharded over a 1-D
device mesh.

Port of `sim5_tpu/parallel/mesh.py`.  Rays never cross devices, so images
and spectra split by rows or by rays with no communication until the end:
an all-gather of the image rows, an all-reduce of a spectrum, a loss and
its gradient.  PyTorch's idiom takes the place of the JAX package's
`jax.sharding.Mesh` and XLA-inserted collectives: SPMD over
`torch.distributed`, one process a GPU, NCCL between the cards (gloo when
the caller asks for the CPU), and a 1-D
`torch.distributed.device_mesh.DeviceMesh` whose dim is named "rays".

A rank renders only its rows: the disk image kernels take a row window
(`render_disk_image(..., row0=, rows=)`), each pixel computed as in the
whole frame.  Rows are split as `shard_image_rows` splits them: padded
with the last row to a multiple of the mesh's size, rank k taking the
k-th block.

Several processes: start one a GPU, by a launcher (`torchrun
--nproc-per-node=N`: `make_mesh()` joins its world through the
environment it sets) or by `init_distributed` with a coordinator;
`make_mesh()` then spans them all.  One process needs no launcher:
`make_mesh()` sets up a group of one rank.  `COLLECTIVES` counts the
collectives these functions issue.  The fit's stages run under
`torch.profiler.record_function` ranges named in `FIT_STAGES` while a
profiler runs, and under none otherwise: an empty range costs the host
~10 us even with no profiler (PERF.md §5).
"""

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..core import r_ms
from ..core.metric import default_device
from ..disk import nt_setup
from ..render.image import render_disk_image

AXIS = "rays"
# collectives issued by this package's sharded paths, by kind
COLLECTIVES = {"all_reduce": 0, "all_gather": 0}
# the record_function ranges of a fit step, in the order it runs them:
# parameters, target rows and nt_setup; this rank's rows and its share of
# the loss's numerator; autograd's backward; the all-reduce and the loss;
# Adam (its optimizer built, the carried state cloned, one step)
FIT_STAGES = ("fit.setup", "fit.forward", "fit.backward", "fit.all_reduce",
              "fit.adam")


def _stage(name):
    """The fit's stage `name` as a record_function range while a profiler
    runs, else no range."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


def _backend(device):
    return "gloo" if device.type == "cpu" else "nccl"


def _device(device):
    """The rank's device: `device`, else the current card; raises where
    there is no card and the caller did not ask for the CPU."""
    dev = default_device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the mesh on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _launcher(name):
    """The launcher's integer variable `name` in the environment
    (`torchrun` sets WORLD_SIZE, RANK and LOCAL_RANK), or None."""
    value = os.environ.get(name)
    return None if value is None else int(value)


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     device=None):
    """Join a group of `num_processes` processes, one a GPU (a no-op for
    one process, as in the JAX package).  `coordinator` is rank 0's
    "host:port" or an init URL (tcp://, file://); None reads the launcher's
    environment (env://: MASTER_ADDR and MASTER_PORT, as `torchrun` sets
    them).  num_processes and process_id default to the launcher's
    WORLD_SIZE and RANK.  The backend is NCCL on the card and gloo where
    `device` is the CPU.  On the card, a process with no device index
    takes card LOCAL_RANK (the launcher's), else process_id, modulo the
    cards."""
    if num_processes is None:
        num_processes = _launcher("WORLD_SIZE")
    if num_processes is None or num_processes <= 1:
        return
    if process_id is None:
        process_id = _launcher("RANK")
        if process_id is None:
            raise ValueError(f"a group of {num_processes} processes: pass "
                             "process_id (or start under a launcher that "
                             "sets RANK)")
    dev = default_device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to join "
                               "the group on the host")
        if dev.index is None:
            local = _launcher("LOCAL_RANK")
            card = process_id if local is None else local
            dev = torch.device("cuda", card % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if coordinator is None:
        url = "env://"
    elif "://" in coordinator:
        url = coordinator
    else:
        url = f"tcp://{coordinator}"
    dist.init_process_group(_backend(dev), init_method=url,
                            world_size=num_processes, rank=process_id)


def make_mesh(devices=None, axis_name=AXIS, device=None):
    """A 1-D DeviceMesh over every rank of the process group (`devices`,
    if given, lists them: all of the group's ranks).  Where no group
    exists, a process that a launcher started in a world of several
    (WORLD_SIZE > 1, as `torchrun` sets it) joins that world through
    `init_distributed`; any other sets up a group of this one process on a
    HashStore, so one card needs no launcher.  The mesh is on the card
    unless `device` is the CPU.  For rows across hosts and rays across
    each host's cards, slice a 2-D mesh instead: `init_device_mesh("cuda",
    (hosts, cards), mesh_dim_names=("hosts", "rays"))["rays"]`."""
    if not dist.is_initialized():
        if (_launcher("WORLD_SIZE") or 1) > 1:
            init_distributed(device=device)
        else:
            dev = _device(device)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                    rank=0, world_size=1)
    dev = _device(device)
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r)
                                                        for r in devices]
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"a mesh of ranks {ranks} in a group of {world}: "
                         "make_mesh spans the whole group (slice a 2-D "
                         "init_device_mesh for sub-groups)")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(dev.type, ranks, mesh_dim_names=(axis_name,))


def check_mesh(mesh):
    """`mesh` if it is a 1-D DeviceMesh, else ValueError (a JAX Mesh, say,
    has no ranks to split over)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1:
        raise ValueError(f"mesh= takes a 1-D torch.distributed DeviceMesh "
                         f"(parallel.make_mesh), not {mesh!r}")
    return mesh


def mesh_device(mesh):
    """The device of this rank's part of the mesh."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def _split(n, mesh):
    """(row0, rows, block) of this rank's rows of n: block = ceil(n /
    size) rows a rank, of which the first `rows` (possibly 0) are real."""
    size, rank = check_mesh(mesh).size(), mesh.get_local_rank()
    block = -(-n // size)
    row0 = min(rank * block, n)
    return row0, min(block, n - row0), block


def _pad_rows(arr, total):
    """arr padded to `total` rows with its last row (zeros if it has
    none)."""
    pad = total - arr.shape[0]
    if pad == 0:
        return arr
    last = (arr[-1:] if arr.shape[0] else
            torch.zeros((1,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                        device=arr.device))
    return torch.cat([arr, last.expand((pad,) + tuple(arr.shape[1:]))])


def shard_image_rows(arr, mesh):
    """This rank's rows of `arr` (rows first), padded with the last row to
    a multiple of the mesh's size: the k-th of size equal blocks."""
    arr = torch.as_tensor(arr)
    _, _, block = _split(arr.shape[0], mesh)
    start = mesh.get_local_rank() * block
    return _pad_rows(arr, block * mesh.size())[start:start + block]


def gather_rows(local, mesh, n):
    """Every rank's rows of `local` (this rank's block, as
    `shard_image_rows` cuts it) gathered in rank order, the pad dropped:
    the first n rows.  One all_gather_into_tensor on NCCL, all_gather on
    gloo."""
    group = mesh.get_group()
    local = local.contiguous()
    size = mesh.size()
    COLLECTIVES["all_gather"] += 1
    if dist.get_backend(group) == "nccl":
        out = torch.empty((size * local.shape[0],) + tuple(local.shape[1:]),
                          dtype=local.dtype, device=local.device)
        dist.all_gather_into_tensor(out, local, group=group)
    else:
        parts = [torch.empty_like(local) for _ in range(size)]
        dist.all_gather(parts, local, group=group)
        out = torch.cat(parts)
    return out[:n]


def all_reduce(t, mesh):
    """Sum `t` over the mesh's ranks in place; returns it."""
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(t, group=mesh.get_group())
    return t


def _render_rows(mesh, disk, incl, npix_x, npix_y, rmax):
    """This rank's rows of the frame (image_f, image_g), each padded to the
    rank's block: (block, 2, npix_x)."""
    row0, rows, block = _split(npix_y, mesh)
    if rows:
        f, g = render_disk_image(disk, incl, npix_x, npix_y, rmax, row0,
                                 rows)
        both = torch.stack([f, g], 1)
    else:
        both = torch.zeros((0, 2, npix_x), dtype=disk.a.dtype,
                           device=disk.a.device)
    return _pad_rows(both, block)


def render_disk_image_sharded(mesh, M, a, mdot, alpha_visc, incl,
                              npix_x=512, npix_y=512, rmax=None):
    """Render an NT-disk image with pixel rows sharded over the mesh: each
    rank sets up the disk, renders its rows (the row-windowed kernel on
    the card, the plain version on the CPU), and one all-gather returns
    the whole (npix_y, npix_x) image_f and image_g on every rank, f64.
    rmax defaults to r_ms(a) + 8."""
    dev = mesh_device(mesh)
    M, a, mdot, alpha_visc = (torch.as_tensor(v, dtype=torch.float64,
                                              device=dev)
                              for v in (M, a, mdot, alpha_visc))
    if rmax is None:
        rmax = float(r_ms(a)) + 8.0
    disk = nt_setup(M, a, mdot, alpha_visc)
    local = _render_rows(mesh, disk, incl, npix_x, npix_y, rmax)
    both = gather_rows(local, mesh, npix_y)
    return both[:, 0].contiguous(), both[:, 1].contiguous()


def _params(params, dev):
    """The fit's parameters as one detached f64 (3,) or (4,) tensor on
    `dev`."""
    if isinstance(params, torch.Tensor):
        p = params.detach().to(dtype=torch.float64, device=dev)
    else:
        p = torch.stack([torch.as_tensor(v, dtype=torch.float64).to(dev)
                         .detach().reshape(()) for v in params])
    if p.shape not in ((3,), (4,)):
        raise ValueError(f"params of shape {tuple(p.shape)}: (M, a, mdot) "
                         "or (M, a, mdot, incl)")
    return p.clone()


def loss_and_grad_sharded(mesh, params, target_image, incl=None,
                          npix_x=64, npix_y=64, rmax=None):
    """The fit's loss, mean((img - target)^2) / max(mean(target^2),
    1e-300), and its gradient in `params` ((M, a, mdot) with `incl` held,
    or (M, a, mdot, incl)), with pixel rows sharded over the mesh: each
    rank renders its rows and differentiates its share of the loss's
    numerator through the image kernels (one forward and one backward
    launch on the card), and one all-reduce of one small tensor sums the
    gradients, the numerator and the target's power.  rmax defaults to
    r_ms(a) + 8.  Returns (loss, grad), a 0-dim and a (3,) or (4,) f64
    tensor on the mesh's device, the same on every rank."""
    dev = mesh_device(mesh)
    with _stage("fit.setup"):
        p = _params(params, dev).requires_grad_(True)
        fit_incl = p.shape[0] == 4
        if not fit_incl and incl is None:
            raise ValueError("a fixed-incl fit needs the incl argument")
        if rmax is None:
            rmax = float(r_ms(p[1].detach())) + 8.0
        target = torch.as_tensor(target_image).to(dtype=torch.float64,
                                                  device=dev)
        row0, rows, _ = _split(npix_y, mesh)
        mine = shard_image_rows(target, mesh)[:rows]
        disk = nt_setup(p[0], p[1], p[2], 0.1)
        incl_t = p[3] if fit_incl else incl
    if rows:
        with _stage("fit.forward"):
            imf, _ = render_disk_image(disk, incl_t, npix_x, npix_y,
                                       float(rmax), row0, rows)
            num = ((imf - mine) ** 2).sum()
        with _stage("fit.backward"):
            (grad,) = torch.autograd.grad(num, p)
    else:
        num = torch.zeros((), dtype=torch.float64, device=dev)
        grad = torch.zeros_like(p)
    with _stage("fit.all_reduce"):
        sums = all_reduce(torch.cat([grad, num.detach()[None],
                                     (mine ** 2).sum()[None]]), mesh)
        k = p.shape[0]
        npix = npix_x * npix_y
        norm = torch.clamp(sums[k + 1] / npix, min=1e-300)
        return sums[k] / npix / norm, sums[:k] / npix / norm


def fit_step_sharded(mesh, params, target_image, incl=None, npix_x=64,
                     npix_y=64, lr=1e-2, opt_state=None, rmax=None):
    """One Adam step of fitting disk parameters to a target image, the
    "training step" of this package: `loss_and_grad_sharded` (pixel rows
    sharded over the mesh, data parallel; one all-reduce) and one step of
    torch.optim.Adam(lr) (eps 1e-8, bias-corrected: optax.adam's update).

    `params` is (M, a, mdot) with `incl` held fixed, or (M, a, mdot, incl)
    to fit the inclination too, as floats or one f64 tensor.  The loss is
    mean((img - target)^2) / max(mean(target^2), 1e-300), O(1) for any
    disk.  Pass the returned `opt_state` back in to continue the Adam
    trajectory: it carries the observer-plane grid's rmax, fixed from
    `rmax` (or r_ms of the first spin + 8) on the first call and never
    rebuilt from the spin iterate.

    Returns (new_params, loss, opt_state): new_params a (3,) or (4,) f64
    tensor, loss a 0-dim f64 tensor, opt_state (adam_state, rmax) with
    adam_state the optimizer's state of the parameter tensor
    (`adam_state_from_numpy` makes one from optax's).
    """
    dev = mesh_device(mesh)
    p = _params(params, dev)
    if opt_state is None:
        adam_state = None
        if rmax is None:
            rmax = float(r_ms(p[1])) + 8.0
    else:
        adam_state, rmax = opt_state
    rmax = float(rmax)
    loss, grad = loss_and_grad_sharded(mesh, p, target_image, incl, npix_x,
                                       npix_y, rmax)
    with _stage("fit.adam"):
        opt = torch.optim.Adam([p], lr=lr)
        if adam_state is not None:
            opt.state[p] = {key: v.clone() for key, v in adam_state.items()}
        p.grad = grad
        opt.step()
    return p.detach(), loss, (dict(opt.state[p]), rmax)


def adam_state_from_numpy(count, mu, nu, rmax, device=None):
    """`fit_step_sharded`'s opt_state from optax's: the leaves of a
    `ScaleByAdamState` (count, and mu and nu of the 3 or 4 parameters) as
    numpy, and the grid's rmax.  A fit begun in the JAX package goes on
    here; `device` is the card unless the caller asks for the CPU."""
    dev = _device(device)
    state = {
        "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
        "exp_avg": torch.as_tensor(np.asarray(mu, np.float64).ravel(),
                                   device=dev).clone(),
        "exp_avg_sq": torch.as_tensor(np.asarray(nu, np.float64).ravel(),
                                      device=dev).clone(),
    }
    return state, float(rmax)

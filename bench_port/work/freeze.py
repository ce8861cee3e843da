"""Freeze the per-unit work of the kernels the benchmark's roofline readers
price, from the port's own counters at the cells' shapes; run once, on
the card, from the repository's root:

    python3 bench_port/work/freeze.py <commit> <chip call> [<kernel> ...]

It writes work/<kernel>.json beside this file (every kernel below, or
those named): each count a unit (a
pixel, a pixel and order, a ray-step) with how it was counted, the
commit of the port it counted and the chip call.  The benchmark reads
only those files at run time, never the port's counters, so its
yardstick stays where it is when a later change rewrites a kernel.

The counts are those of `chip_smoke.py`'s bounds: the image and tangent
kernels' operations by pixel class from the counted instance's counters
(`image_ops`, `jvp_bound`; a division, square root or transcendental
counted as the length of its SASS sequence), the march's operations per
trial step counted from its source (`OPS_TRIAL`, `OPS_RT`), the seed's
and the crossing map's operations from the counting scalar
(`kernel_analytic.operation_counts`, each operation one).  Each is taken
at the cell's own shape and inputs: the sweeps' a0 = 0.998 (bench.py's),
the spot's a = 0.5, incl = 70 deg.
"""

import json
import math
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent.parent
sys.path.insert(0, str(ROOT))


def write(name, body, commit, call):
    body = dict(body, commit=commit, chip_call=call)
    (HERE / f"{name}.json").write_text(json.dumps(body, indent=1) + "\n")
    print(name, json.dumps(body), flush=True)


def main(commit, call, *names):
    import torch
    import chip_smoke as cs
    from sim5_tpu_torch.disk import nt_setup
    from sim5_tpu_torch.render import kernel_analytic as ka
    from sim5_tpu_torch.render import kernel_image as ki
    dev = torch.device("cuda", 0)
    npix, incl = 512, math.radians(80.0)
    lengths = cs.op_lengths()

    def wanted(name):
        return not names or name in names

    def write_if(name, body):
        if wanted(name):
            write(name, body, commit, call)

    def counters(frames, dt):
        spins = (0.998 - 2e-4 * torch.arange(frames, dtype=torch.float64,
                                             device=dev)).to(dt)
        full = [torch.full((frames,), v, dtype=dt, device=dev)
                for v in (10.0, 0.1, 0.1)]
        disk = nt_setup(full[0], spins, full[1], full[2])
        ki.count_disk_image(disk, incl, npix, npix)
        torch.cuda.synchronize()
        return ki.image_counters()

    for dt, p, frames in ((torch.float32, "f32", 256),
                          (torch.float64, "f64", 64)):
        if not wanted(f"disk_image_{p}"):
            continue
        c = counters(frames, dt)
        item = torch.tensor([], dtype=dt).element_size()
        write_if(f"disk_image_{p}", dict(
            precision=p,
            ops_per_pixel=cs.image_ops(dt, c, lengths) / (frames * npix ** 2),
            bytes_per_pixel=2 * item, bytes_per_frame=6 * item,
            how=f"chip_smoke.image_ops({dt}, counters, op_lengths()) of "
                f"the counted nt_image over {frames} frames of the sweep at "
                "a0=0.998, 512^2, incl 80 deg, over the pixels; bytes: the "
                "two images written, the frame's six scalars read"))
    if wanted("disk_image_jvp_f64"):
        dt = torch.float64
        c64 = counters(64, dt)
        _, ops = cs.jvp_bound(dt, c64, lengths, npix, k=4, reduce=True)
        write_if("disk_image_jvp_f64", dict(
            precision="f64", ops_per_pixel=ops / (64 * npix * npix),
            bytes_per_pixel=16, bytes_per_frame=8 * 6 * 5,
            how="chip_smoke.jvp_bound(float64, counters, op_lengths(), 512, "
                "k=4, reduce=True) operations (the backward in a, incl, mdot "
                "is the four-slot reduction instance) over 64 frames at "
                "a0=0.998, over the pixels; bytes: grad_f and grad_g read, "
                "each frame's six scalars and 4 x 6 tangents read"))
    if not any(map(wanted, ("march_f32_emission", "volume_seed_f64",
                            "crossing_map_f64"))):
        return  # none of the held cells' kernels asked for
    write_if("march_f32_emission", dict(
        precision="f32", ops_per_step=cs.OPS_TRIAL + cs.OPS_RT[1],
        bytes_per_ray=cs.BYTES_RAY + 4,
        how="chip_smoke.OPS_TRIAL + OPS_RT[1]: FP32 operations of one "
            "trial step of march_f32<GR, no POL, emission> counted from "
            "its source (a multiply-add two), the transfer term on every "
            "trial; bytes: chip_smoke.BYTES_RAY and the f32 intensity"))
    a, inc, rmax = 0.5, math.radians(70.0), 17.5
    seed = ka.operation_counts("seed", a, inc, npix, rmax, r_start=40.0,
                               dtype=torch.float64, axisymmetric=False,
                               threads=8, adaptive=True)[0]
    write_if("volume_seed_f64", dict(
        ops_per_pixel={p: sum(seed[p].values()) / npix ** 2
                       for p in ("f64", "f32")},
        bytes_per_pixel=2 * 4 * 8 + 1,
        how="kernel_analytic.operation_counts('seed', 0.5, 70 deg, 512, "
            "17.5, r_start=40, float64, azimuth, adaptive=True): every "
            "operation one, over the pixels; bytes: x0, k (f64) and the "
            "valid mask written"))
    cm = ka.operation_counts("crossing", a, inc, npix, rmax, (0, 1),
                             threads=8, adaptive=True)[0]
    write_if("crossing_map_f64", dict(
        ops_per_pixel_order={p: sum(cm[p].values()) / (2 * npix ** 2)
                             for p in ("f64", "f32")},
        bytes_per_pixel_order=4 * 8 + 1,
        how="kernel_analytic.operation_counts('crossing', 0.5, 70 deg, 512, "
            "17.5, orders (0, 1), adaptive=True): every operation one, "
            "over the pixels and orders; bytes: r, phi, g, dt (f64) and hit "
            "written"))


if __name__ == "__main__":
    main(*sys.argv[1:])

#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one GPU: the stepwise Kerr ray march,
volume radiative transfer, the Novikov-Thorne disk image, the analytic
azimuth and travel time, the hot-spot light curve, the equatorial
thin-disk products (the shadow, polarized images and spectra, line
profiles and transfer functions), the disk raytracing driver (the
thick-disk surface solve, DiskRaytrace images and spectra, and the
differentiable spectrum), the derivative layer (the disk image's
gradient through its tangent kernel, and the reverse-differentiable
march), the spectral tables, frame checkpoints and host IO, the parallel
layer (row windows of the image kernels, the sharded render, the
data-parallel Adam fit, DiskRaytrace and the tables with mesh=), every
example of the port, and emission and absorption models of any
elementwise torch ops traced into the march kernel.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

The march kernel (`sim5_tpu_torch/csrc/march.cuh`, run in segments with
the live rays compacted between them: `csrc/march.cu` for its compiled-in
GaussianSource family, all its variants), the disk image kernel
(`sim5_tpu_torch/csrc/disk_image.cu`, f64 and f32), its tangent
kernel (`sim5_tpu_torch/csrc/disk_image_jvp.cu`), the analytic engine's
crossing-map and volume-seed kernels (`csrc/crossing_map.cu`,
`csrc/volume_seed.cu`, on `csrc/azimuth.cuh`) and their host operation
counter (`csrc/analytic_ops.cpp`, g++) are built into `build/` on first
use, all at once; the march libraries generated for traced
models (`sim5_tpu_torch/march/model_trace.py`) into
`build/sim5_tpu_torch/gen/` at their first use.  Phases, one line each:

1. device: the card's name and power limit, the builds (with a probe of
   single-function kernels for the SASS lengths of divisions, square roots
   and transcendentals), each kernel's compile-time choices, registers,
   spills and resident blocks of every main-path instance, of every
   instance of the tangent kernel and of the analytic kernels, and the
   SASS instruction counts where `cuobjdump` is there;
2. kernel vs its plain torch version on 4096 rays (GR, GR+POL, flat at
   a = 0.3 and 0.9);
3. the march's main path, 131072 rays at a = 0.9 to r = 500, through
   raytrace_prepare -> raytrace_kernel -> raytrace_error, with the
   reference's Carter-drift gates, the launch counts and the lane
   counters (lane-trips == sum of steps);
4. the f64 torch engine on 8192 rays of the same workload, same gates;
5. the march timed at 131072 rays (CUDA events, the minimum of
   TIMED_RUNS): ms, ray-steps/s, lane use and the bound, every run bitwise
   equal to the first; the time of each segment; the plain version once;
6. the transfer variants vs their plain version on the volume seed of
   64^2 pixels (example 11's torus, thin and thick);
7. the volume path's main path: volume_image(engine="kernel") at 512^2
   for alpha0 = 0 and 1, with the launch counts and the image gates;
8. the kernel route against the f64 loop engine at 96^2;
9. phase 5's timing and gates for the transfer variants at 512^2, thin
   and thick, and their plain version once;
10. the disk image against the C goldens on the card (128^2, a = 0 and
    0.998): the f64 kernel and the f64 plain version, each within 1e-6 of
    the peak with the golden's footprint (ondevice_f64_err_a0 / a998);
11. the disk image's main path, bench.py's headline frame (512^2, a =
    0.998, i = 80 deg, M = 10, mdot = 0.1, alpha = 0.1) through nt_setup ->
    render_disk_image in f64 and f32: the f64 kernel against the f64 plain
    version (1e-9 of the peak), the f32 kernel and the f32 plain version
    against the f64 plain version (4e-6 of the peak, footprint mismatch
    <= 1e-5 of the pixels: fast_path_err_vs_f64), one launch of each
    instance, and each launch's in-kernel counters, held against its image;
12. the disk image timed, by CUDA events around runs of IMAGE_REPS
    launches (min / median / max of IMAGE_RUNS): one headline frame a
    launch, 64 frames of the spin sweep (a = 0.998 - 2e-4 k) in one launch
    (device_ms_per_frame is a frame of the f32 one), the entry point one
    frame a call; every frame of the 64-frame launch bitwise its
    single-frame launch, in both instances; the f64 kernel on a batch of
    three spins at 128^2 against the plain version (1e-9 of the peak); the
    f32 spin sweep through nt_setup(spins) -> render_disk_image in one
    launch and as one call a frame, on the host clock (frames/s, one build
    for all spins); the plain versions once, and the bound from the main
    path's counters;
13. the analytic azimuth and travel time on the card: phi against the C
    golden's position samples (geod.txt, at least 97% within rtol 1e-4,
    atol 1e-6), the time delay against timedelay.txt (95% within rtol
    1e-5, atol 1e-7); then the kernels on the card (one launch each of
    volume_seed<double, true> and crossing_map<double>, counted) against
    the plain chains on the CPU in f64 at 64^2, for the volume seed's
    azimuth and the crossing map's (r, phi, g, delay): r and g within
    1e-12 relative, phi and the delay within their per-pixel bounds
    (`phi_bound`, `time_bound`);
14. the volume path with its default azimuth stage and an orbiting
    source (example 07's spot as a 3-D `GaussianSource`: a = 0.5, 70 deg,
    r = 7, width, height and arc 0.7, omega = OmegaK(7, 0.5)):
    volume_image(engine="kernel") at 512^2 thin and thick with the
    launch counts (the seed kernel once an image) and phase 7's gates,
    the seed timed (the kernel's rays, raytrace_prepare), phase 8's gates
    at 128^2, the flux one orbital period later
    equal to 1e-3 (volume_lightcurve), and the march timed on the 512^2
    seed and held against its plain version on the same inputs, as in
    phase 9;
15. example 07's hot-spot light curve at its full size
    (hotspot_lightcurve at 192^2, orders 0 and 1, 96 samples over two
    periods): each crossing map (one crossing_map<double> launch each),
    the curve given the maps and the entry point (both orders in one
    launch, counted) timed, and the crossing map at 512^2; finite and positive,
    sample k equal to sample k + 48 to 1e-9, delays of the hit pixels
    from exactly 0;
16. example 09 at its full size: render_bh_image at 512^2 (a = 0.998,
    80 deg, rmax 10, nt_setup(10, a, 0.1, 0.1), inner emissivity 1e22
    r^-3), first call and the min of 5 warm calls (host clock,
    synchronised), its op count from the CPU run and the share ops x 7.2
    us takes of the time; the shadow fraction and the g range; the card
    against the CPU at 64^2 (masks equal but for lanes within 1e-10 of
    their threshold; r 1e-12 relative, g and flux within a bound that
    grows with the plunging g-factor's rounding noise); test_shadow.py's
    Schwarzschild area and masks-and-flux gates; imetric on the card;
17. examples 06 and 10 at their full sizes: render_polarized_image at
    256^2 and polarized_spectrum at 192^2 x 20 energies (a = 0.9, 70 deg),
    timed as phase 16; example 06's integrated degree and angle and
    example 10's table; the card against the CPU at 64^2 (I 1e-11
    relative, Q and U 1e-11 of I; the spectrum 1e-12 of I_E);
    test_polarized_spectrum.py's face-on and inclined degree gates; the
    goldens tazm, tsurf, wp, pvec and prot on the card;
18. line_profile (256^2, orders 0 and 1, 200 bins) and
    transfer_function (384^2, 8 x 64 bins), timed as phase 16; the card
    against itself (atomic sums, 1e-13 of the peak) and against the CPU at
    64^2 (1e-12 of the peak, bins equal but for pixels at a bin edge);
    test_driver.py's line-shape gates and T.sum() == hit.sum() dA;
19. the thick-disk surface solve on tests/test_driver.py's cone (H =
    0.05 R outside r = 6, a = 0.5, 55 deg): find_surface_march on the 24
    rays of thickdisk_cone_a05.npy against the reference (hit set equal,
    r rtol 1e-10, m atol 1e-12), find_surface on them (residual 1e-9, r
    within 0.05 of the march, hit sets agreeing on > 0.9), the card
    against the CPU in f64 (find_surface on those rays and at 64^2, the
    march on those rays: ok equal, r and m 1e-9 relative), example 12's
    image (DiskRaytrace.image at 96^2, f64: hit fraction > 0.2, max |H| >
    0.1) and bench.py's thick-disk workload in f32 (the 256^2 image: hit
    fraction > 0.2, median residual < 1e-3; its 8-inclination sweep as 8
    eager calls, min of 3 on the synchronised host clock:
    thickdisk_rays_per_sec, with a frame's op count from the CPU run);
20. the thin-disk driver and spectra: DiskRaytrace.image (32^2) and
    spectrum against the reference Python layer's goldens
    (tests/test_driver.py's tolerances), example 05 at its full size (a =
    0.7, 60 deg, radres 0.3, angres 45, 64 energies over 0.1-50 keV),
    timed as phase 16 (spectrum_rays_per_sec, the op count, the coverage
    error, the card against the CPU to 1e-12 of the peak), f32 against
    f64 (< 1e-5), the card against the CPU at radres 2, angres 10 (1e-12
    of the peak), and disk_spectrum against the driver (2e-2) with its
    autograd d log sum / da against central differences (rtol 0.05);
21. the image's gradient through the tangent kernel (nt_frames_jvp<T, K>
    + nt_image_jvp<T, K[, reduce]> + nt_reduce<T> of
    csrc/disk_image_jvp.cu, K tangent slots a pass): bench.py's per-pixel
    tangent in spin on the 128^2 f64 frame (a = 0.998) by forward mode
    through render_disk_image, against the plain version's forward mode
    on the card (1e-8 of the peak tangent on the interior pixels) and
    against central differences of the f64 kernel (h = 1e-4, interior >
    0.9, pixel_grad_linf_vs_fd <= 1e-3); the backward in (a, incl, mdot)
    of three spins at 128^2, f64, against the plain version's
    autograd.grad (1e-9 relative), one reduction launch for its five
    columns, timed; bench.py's throughput workload, value and grad of
    imf.sum() * 1e-25 in (a, incl, mdot) over the 64-frame f32 spin sweep
    at 512^2 through nt_setup(spins) -> render_disk_image -> backward
    (grad_rays_per_sec, the minimum of 3 on the synchronised host clock;
    finite, nonzero, two runs bitwise equal; one forward launch and one
    reduction launch whatever the column count); that backward alone by
    CUDA events with its bound, beside one one-slot launch (a column, as
    PR 9 launched each); the f32 backward of four frames of that sweep
    against the plain f32 autograd.grad, relative to the f64 gradient
    (3e-3 for the sweep's loss; 1e-5 for the same sum over the pixels
    whose f32 tangents the plain f32 chain resolves, each within 1e-4 of
    the f64 tangent's peak), timed; the four-slot instance's tangents on
    the headline frame, f64 and f32, bitwise those of four one-slot
    launches; each one-slot instance's forward mode on the headline frame
    against the plain version's (f64: 1e-8 of the peak tangent; f32: 5e-4
    of the f64 peak tangent on the resolved pixels, which must be all but
    0.5% of the footprint), timed by CUDA events, with its bound; the
    registers, spills and resident blocks of every instance;
22. volume_image(engine="scan") on example 11's torus in f64 over 512
    steps (its 2000 cut to 8 whole segments of 64, to leave room for
    phases 23-27): against the loop engine at
    96^2 (rtol 1e-12); at 256^2, the largest power-of-two size whose
    checkpointed segments fit, the forward and the backward of d I.sum()
    / d(a, the torus' radius) timed, and the gradient against central
    differences (h = 1e-5, rel < 1e-5) on the rays where FD is a
    derivative (the trial count holds within +-h, and FD with h and h / 2
    agree to 1e-6), with the dropped rays' count by cause, their gradient
    and their FD at h, h / 2 and h / 4;
23. the spectral tables (no kernel: eager torch rows): example 08's grid
    at its full size (3 spins x 3 mdots x 3 inclinations, 64 energies
    over 0.1-30 keV, radres 0.5, angres 20) through generate_disk_table
    on the card in f64 and fast (f32), each row timed with its save; the
    fast rows within 1e-5 relative of the f64 rows on the bins above 1e-6
    of each peak; three f64 rows again on the host's CPU (1e-9 there); a
    child process running the grid, SIGKILLed after 5 rows, then resumed
    here: bitwise the uninterrupted table; the polarized grid (3 spins x 3
    inclinations, 128^2, 20 energies) through generate_polarized_table;
    a table's save() against save_async through the native writer;
24. frame checkpoints and host IO: checkpointed_frames over the first 32
    frames of the spin sweep (f32, 512^2, one nt_image launch a frame,
    flushed every 4 frames through the native AsyncWriter), uninterrupted
    and interrupted after 12 frames then resumed: bitwise each other and
    the frames of one launch of all 32; the stack's save() against
    save_async; a 4-frame stack of example 07's orbiting spot through
    volume_image(engine="kernel") at 128^2 (t0 a quarter period apart),
    interrupted after 2 frames and resumed, bitwise; the checkpointed hot
    spot light curve (16 times over two periods in chunks of 8, 128^2,
    orders 0 and 1: the chunks one period apart within 1e-9); the external
    disk bridge (tests/data/external_diskmodel.c built with cc into
    build/) rendering a 48^2 DiskRaytrace image on the card against the
    model written in torch (the same footprint, 1e-5); the native writer
    built under build/ and loaded, native/ unchanged;
25. the parallel layer on the card: make_mesh() as a one-rank NCCL group;
    the headline frame (512^2, f64 and f32) in the row windows that
    meshes of 1, 3 and 7 ranks give their ranks (blocks of 512, 171 and
    74 rows), bitwise the one-launch frame, and the backward in (a, incl,
    M, mdot) summed over the windows against the whole frame's (1e-12
    relative in f64, 1e-5 of the f64 gradient in f32);
    render_disk_image_sharded bitwise render_disk_image; fit_step_sharded
    at 512^2 in f64 for 5 Adam steps toward the headline frame (the loss
    falls; each step timed on the synchronised host clock, its launches
    counted from 0: 2 forward, 3 backward, 1 all-reduce), step 1's
    gradient at 128^2 against the plain version's autograd.grad (1e-9
    relative); DiskRaytrace.image(mesh=) on the cone at 96^2 and
    .spectrum(mesh=) at example 05's size, and a generate_disk_table(mesh=)
    row, each bitwise its call without a mesh;
26. every examples/torch_*.py on the card in this process (runpy): 01,
    04, 05 and 11 at full size, the others at SIM5_FAST (their full-size
    paths are phases 15-17, 23 and 24); each one's printed numbers finite
    and not all zero;
27. emission and absorption models outside the GaussianSource family,
    traced into the march kernel: every generated library of the phase
    built together (cold and cached seconds, each instance's ptxas);
    example 11's torus as its own plain functions through
    volume_image(engine="kernel") at 512^2, thin and thick, with the
    launch counts, within 1e-5 of the peak of phase 7's GaussianSource
    images (and whether bitwise), its march timed on the 512^2 seed with
    equal steps on > 0.999 of the rays against phase 9's; a power-law
    corona and a two-armed spiral (time and azimuth), thin and thick,
    against the plain version on 4096 ZAMO rays and on a 64^2 seed
    (equal steps > 0.9, |dI| <= 1e-3 of the peak), the corona's 64^2
    march timed (the kernels line's traced rows) and its 512^2 thick
    march, the spiral's image at 128^2; test_march.py's flare light
    curve at two times and at a second t_flare, and example 11's alpha
    sweep, each absorption and each flare on one cached library; an
    unsupported op and data-dependent control flow refused on the card
    before any build or launch;
28. (run before 13) the analytic engine's kernels against their plain
    torch chains on the card, each two passes over a work list: the
    crossing map (crossing_classify<double>, crossing_hits<double>) at
    example 07's 192^2, orders 0 and 1 in one launch of each pass (hit sets
    equal; g 1e-12 relative; r 1e-12 relative + `far_bound`, the far
    field's r^2 dP with dP 32 ulps of Tpp + |Tip|, which order 1's
    crossings at r ~ 1e4-1e5 need; phi and the delay within `phi_bound` /
    `time_bound` (+ `far_bound`); the pixels that are no hit exactly the
    plain chain's); the seed (seed_geometry<T, azm>, seed_azimuth<T>) on
    example 07's spot at 512^2 in f64 and f32, with and without the
    azimuth, and on example 11's torus (f64, axisymmetric): f64 valid sets
    equal, r0, m0 and k within `seed_bounds` (1e-12 of max(|v|, 1e-3 of the
    field's peak), and the square root's spread where k^r or k^theta passes
    through 0), phi0 within `phi_bound`, the dummy rays exact; f32 against
    the f64 chain no further than 2x the plain f32 chain's own distance +
    1e-6 of each field's scale, valid sets within 1% of the pixels; every
    output bitwise the same from run to run; each kernel's CUDA-event time,
    each pass's on the card (torch.profiler), its plain chain's, its bound
    from the operations its pixels execute (counted on the host's cores
    beside the phase by `kernel_analytic.operation_counts`, at Carlson's
    rule and at the fixed depth of the one-pass kernels before them) and
    its FP64 issue-slot bound (the FP64-pipe instructions of each
    operation's SASS); a crossing map past 2^26 pixels and orders, bitwise
    from run to run; then the counted instances of the two passes
    (`kernel_analytic.counted_run`: per stage warps, lanes and cycles, per
    Carlson chain its levels), their outputs bitwise the kernels'.

Then one JSON line on the kernels, the card's name and power limit, and
the result as the last line.  Any failed check exits non-zero.  The script
needs a CUDA device and imports nothing of JAX.

    python3 chip_smoke.py --compare-forward DIR

hashes the forward results (the disk images of the headline frame and
the 64-frame sweep, f64 and f32; the march's family on the main path's
rays and example 11's torus at 128^2, thin and thick) of the checkout at
DIR and of this one, each in its own process, and exits 0 if they are
bitwise equal.

    python3 chip_smoke.py --compare-grad DIR

times the gradient of the checkout at DIR and of this one, each in its
own process, in turns (DIR, this, this, DIR): the f32 sweep's value and
grad (host clock, synchronised), its backward alone and forward mode on
the headline frame, f64 and f32 (CUDA events); it hashes the tangents of
forward mode beside them and prints whether the two trees' are bitwise
equal.

    python3 chip_smoke.py --compare-analytic DIR

times the analytic kernels of the checkout at DIR and of this one, each in
its own process, in turns (DIR, this, this, DIR): the crossing map and the
five seeds of phase 28 (CUDA events) and hotspot_lightcurve's entry point
(host clock, synchronised); it prints the largest distance between the
two trees' outputs.

    python3 chip_smoke.py --tune-analytic

builds the crossing map's and the seed's libraries with one pass at each
of TUNE_ANALYTIC's (threads a block, minimum blocks an SM) pairs, eight
builds at a time, and times each (about 5 minutes): what the committed
kClassify*, kHit*, kGeom* and kAzm* constants were chosen by.

    python3 chip_smoke.py --tune-tangent

builds the tangent kernel (csrc/disk_image_jvp.cu) at each of TUNE_SHAPES'
(threads a block, minimum blocks an SM) pairs and at other slot layouts
(TUNE_SLOTS), eight builds at a time, and times every instance of each
build (about 4 minutes): what the committed jvp_threads and
jvp_min_blocks were chosen by.
"""

import contextlib
import concurrent.futures
import ctypes
import hashlib
import io
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

SEED_MAIN = 3
N_CMP = 4096
N_MAIN = 131072
N_F64 = 8192             # cut from 16384 to keep the script near 600 s
MAIN = dict(a=0.9, precision=0.01, r_max=500.0, max_steps=4000)
# example 11's translucent torus (examples/11_thick_volume_transfer.py),
# axisymmetric seed, at bench.py's headline resolution
VOL = dict(a=0.9, incl=math.radians(70.0), rmax=16.0, r_start=40.0,
           max_steps=2000, precision=0.02, axisymmetric=True)
N_VOL_PIX = 512
N_VOL_CMP = 64
N_VOL_LOOP = 64          # the orbiting source against the f64 loop engine
                         # (cut from 128 to keep the script near 600 s)
N_VOL_LOOP_TORUS = 64    # the torus (cut from 128, then 96, to keep the
                         # script near 600 s)
ALPHA0 = (0.0, 1.0)
# example 07's hot spot (examples/07_hotspot_lightcurve.py: a = 0.5, 70 deg,
# r_spot = 7, size 0.7, two periods in 96 samples at 192^2, orders 0 and 1)
SPOT = dict(a=0.5, incl=math.radians(70.0), r_spot=7.0, size=0.7)
N_HOTSPOT = 192
HOTSPOT_T = 96
N_MAP = 512              # the crossing map at the volume path's resolution
N_ANALYTIC = 64          # the analytic engine, card against the CPU
# the same spot as a 3-D source orbiting at OmegaK(7, 0.5) (width, height
# and arc 0.7), through the volume path with its azimuth stage
VOL_SPOT = dict(a=SPOT["a"], incl=SPOT["incl"], rmax=17.5, r_start=40.0,
                max_steps=2000, precision=0.02, axisymmetric=False)
TIMED_RUNS = 6           # timed runs of each march (the minimum is kept)
# bench.py's headline frame (bench.py:293-295) and its spin sweep
NT = dict(M=10.0, a=0.998, mdot=0.1, alpha=0.1, incl=math.radians(80.0))
N_IMAGE = 512
N_GOLDEN = 128
N_SWEEP = 64             # frames of the spin sweep, a = 0.998 - 2e-4 k
IMAGE_REPS = 20          # launches between two CUDA events
IMAGE_RUNS = 5           # event pairs timed (min, median and max kept)
SWEEP_RUNS = 5           # host-clock runs of each spin sweep
BATCH_SPINS = (0.998, 0.9, 0.3)   # the f64 batch held against the plain one
N_BATCH = 128

# The least time of a march (bound_ms): FP32 operations per trial step,
# counted from csrc/march.cu for the GR, no-polarization instance, a
# multiply-add as two, each division, sqrtf, cosf and expf as one (so the
# bound is a lower one): 4 connection evaluations of 158 (each with one
# sqrtf and 4 divisions), 4 cosf (m is carried from the last accepted
# trial), 4 contractions -Gamma k k of 52, the step size 25, the RK4 stage
# updates and combination 98, the error check 49, accept/reject and
# termination 14.
OPS_TRIAL = 4 * 158 + 4 + 4 * 52 + 25 + 98 + 49 + 14
# per step with transfer: one torus evaluation (19, with its sqrtf and
# expf) and I += j dl; or two evaluations, dtau, s_eff and I += j e^-tau s
# (3 expf); counted on every trial, though only accepted ones run them
OPS_RT = (0, 19 + 2, 2 * 19 + 13)
# bytes per ray: x, k, f, kt, active in; x, k, f, kt, err, steps, active
# out; and I out with transfer
BYTES_RAY = 4 * 13 + 1 + 4 * 15 + 1
H100_FP32 = 67e12        # FP32 FLOP/s outside the tensor cores, 700 W
H100_FP64 = 34e12        # FP64 FLOP/s outside the tensor cores, 700 W
H100_BYTES = 3.35e12     # HBM3 bytes/s

# The least time of a disk image frame (image_bound): the operations each
# pixel class needs, counted from csrc/analytic.cuh, times the pixels of
# that class in the frame (image_counters()), over the peak rate of the
# type.  A piece is (flops, {op: count}): flops are +, -, * (comparisons,
# selects, abs and negation not counted), and each division, square root
# and transcendental counts as the length of its SASS sequence on this card
# (op_lengths(): the instructions of a kernel that computes it, before
# EXIT, less those of x + y).  Where a piece's work depends on data that
# the counters do not split, the cheaper branch is counted (the Jacobi
# AGM's backward pass at one level), and a piece of every pixel is counted
# once a pixel: make_frame's once-a-frame work is left out.  The kernel is
# built with --fmad=false, so each counted operation is one instruction,
# while the peak counts an FMA as two: at the instruction issue rate the
# floor is twice the bound, and phase 12 prints it beside the bound.
def _piece(flops=0, **ops):
    return flops, ops


def _add(*pieces):
    flops, ops = 0, Counter()
    for f, o in pieces:
        flops += f
        ops.update(o)
    return flops, dict(ops)


def pixel_pieces(dtype):
    """{piece: (flops, {op: count})} of one pixel of the disk image in
    `dtype`, by the depths of csrc/analytic.cuh's Prec<T>."""
    f64 = dtype == torch.float64
    rf_dup, k_agm, jac = (16, 9, 13) if f64 else (7, 7, 8)
    rf = _piece(10 * rf_dup + 18, sqrt=3 * rf_dup + 1, div=5)
    K = _piece(3 * k_agm + 2, sqrt=k_agm + 1, div=1)
    sncndn = _piece(4 * jac + 9, sqrt=jac + 1, div=4, sin=1, cos=1)
    vlog = _piece(1, log1p=1) if f64 else _piece(14, div=3)
    rescale = _piece() if f64 else _piece(9, div=1, frexp=3, ldexp=1)
    # the quartic, sort and two-float polish by root pattern, then
    # R_roots' own branch
    rr = _add(_piece(79, div=20, sqrt=5, pow=1, acos=1, cos=3),
              _piece(4 * 107, div=8), _piece(19, sqrt=2, div=4))
    rc = _add(_piece(84, div=19, sqrt=4, pow=2), _piece(2 * 107 + 2 * 74,
                                                       div=4),
              _piece(40, sqrt=4, div=7))
    cc = _add(_piece(84, div=19, sqrt=4, pow=2), _piece(4 * 74),
              _piece(37, sqrt=4, div=8))
    return {
        # the grid, init_inf's own, T_roots, the quartic's coefficients,
        # Tpp's K, Tip's rf and the order-0 crossing
        "pixel": _add(_piece(63, div=10, sqrt=5), K, rf, rescale),
        "RR": rr, "RC": rc, "CC": cc, "rf": rf, "K": K,
        "rad_RR": _add(_piece(30, sqrt=1, div=2), sncndn),
        "rad_RC": _add(_piece(45, sqrt=3, div=6), sncndn),
        "rad_CC": _add(_piece(38, sqrt=3, div=6), sncndn),
        "cross": _piece(3, div=1, sqrt=1),
        # gfactorK, nt_flux with its four vlog, F g^4
        "shade": _add(_piece(65 + 42 + 3, sqrt=3, div=10), *[vlog] * 4),
    }


def pixel_mix(c):
    """{piece: pixels} of a frame from its counters (lanes)."""
    lanes = {k: v[1] for k, v in c.items()}
    return {
        "pixel": lanes["pixels"],
        "RR": lanes["type_RR"] + lanes["type_RR_BH"] + lanes["type_RR_double"],
        "RC": lanes["type_RC"], "CC": lanes["type_CC"],
        "rf": lanes["rf_R"], "K": lanes["K_R"],
        "rad_RR": lanes["rad0_RR"] + lanes["rad1_RR"],
        "rad_RC": lanes["rad0_RC"] + lanes["rad1_RC"],
        "rad_CC": lanes["rad0_CC"] + lanes["rad1_CC"],
        "cross": lanes["order1"], "shade": lanes["shade"]}


def image_ops(dtype, counters, lengths):
    """Operations of the frames the counters describe, each op at its SASS
    length (`lengths`, {(op, 'd' or 'f'): n}; 1 where not measured)."""
    t = "d" if dtype == torch.float64 else "f"
    pieces = pixel_pieces(dtype)
    total = 0
    for piece, n in pixel_mix(counters).items():
        flops, ops = pieces[piece]
        total += n * (flops + sum(k * lengths.get((op, t), 1)
                                  for op, k in ops.items()))
    return total


PEAK = {torch.float64: H100_FP64, torch.float32: H100_FP32}


class PhaseFailed(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise PhaseFailed(msg)


def card(query="name,power.limit"):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# the card's state read right after a timed run: SM clock, its maximum,
# power draw, temperature and the active clock throttle reasons
CARD_STATE = ("clocks.sm,clocks.max.sm,power.draw,temperature.gpu,"
              "clocks_throttle_reasons.active")


def zamo_rays(n, a, seed, dtype, device, outward=0.0, flat=False, pol=False):
    """Rays off ZAMO tetrads at r in [6, 15], |m| < 0.5, random local
    directions (outward-biased by `outward`), from a numpy seed.
    Returns (x, k, f0); f0 is the tetrad's e2 leg when `pol`."""
    from sim5_tpu_torch.core import (kerr_metric, flat_metric, tetrad_zamo,
                                     on2bl)
    rng = np.random.default_rng(seed)
    r = rng.uniform(6.0, 15.0, n)
    m = rng.uniform(-0.5, 0.5, n)
    th = rng.uniform(0.3, np.pi - 0.3, n)
    ph = rng.uniform(0.0, 2 * np.pi, n)

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    r, m, th, ph = t(r), t(m), t(th), t(ph)
    met = flat_metric(r, m) if flat else kerr_metric(t(a), r, m)
    T = tetrad_zamo(met)
    d = torch.stack([torch.sin(th) * torch.cos(ph) + outward,
                     torch.sin(th) * torch.sin(ph), torch.cos(th)], -1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    kloc = torch.cat([torch.ones_like(r)[:, None], d], -1)
    k = on2bl(kloc, T)
    x = torch.stack([torch.zeros_like(r), r, m, torch.zeros_like(r)], -1)
    f0 = on2bl(t([0.0, 0.0, 1.0, 0.0]).expand(n, 4), T) if pol else None
    return x, k, f0


def compare(st_k, st_p, pol):
    """Kernel vs plain results: (equal-steps share, max rel dr, max dtheta,
    max |df|, max |dr|) over the rays with equal step counts."""
    sk, sp = st_k.steps.cpu().numpy(), st_p.steps.cpu().numpy()
    xk, xp = st_k.x.double().cpu().numpy(), st_p.x.double().cpu().numpy()
    eq = sk == sp
    both = eq & np.isfinite(xk[:, 1]) & np.isfinite(xp[:, 1])
    dr = np.abs(xk[:, 1] - xp[:, 1])
    rel = (dr / np.maximum(np.abs(xp[:, 1]), 1.0))[both]
    dth = np.abs(np.arccos(np.clip(xk[:, 2], -1, 1))
                 - np.arccos(np.clip(xp[:, 2], -1, 1)))[both]
    df = 0.0
    if pol:
        fk, fp = st_k.f.double().cpu().numpy(), st_p.f.double().cpu().numpy()
        df = float(np.abs(fk - fp)[both].max())
    return (float(eq.mean()), float(rel.max()), float(dth.max()), df,
            float(dr[both].max()))


# march_f32<GR, POL, RT> in a mangled name
INSTANCE = re.compile(r"march_f32ILb([01])ELb([01])ELi([0-9])E")


def march_label(m):
    return f"GR={m[1]} POL={m[2]} RT={m[3]}"


def ptxas_summary(log, instance=INSTANCE, label=march_label):
    """'<label>: N regs, stack frame and spills' per kernel instance (the
    march's by default), from the compiler's -Xptxas -v report kept beside
    the library."""
    if not os.path.exists(log):
        return "no report (library was cached without its log)"
    out, kernel, spill = [], None, ""
    for ln in open(log).read().splitlines():
        entry = (instance.search(ln) if "Compiling entry function" in ln
                 else None)
        regs = re.search(r"Used (\d+) registers", ln)
        if entry:
            kernel = label(entry)
        elif "spill" in ln and kernel:
            spill = ln.strip()
        elif regs and kernel:
            out.append(f"{kernel}: {regs[1]} regs, {spill}")
            kernel = None
    return "; ".join(out)


SASS_OP = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def _cuobjdump():
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return tool if os.path.exists(tool) else None


def sass_counts(lib_path, instance=INSTANCE,
                key=lambda m: tuple(int(g) for g in m.groups())):
    """{key: Counter of SASS opcodes} of each kernel instance in the
    library (the march's by default, keyed (GR, POL, RT)); a static count:
    each instruction of the function once.  None without cuobjdump."""
    tool = _cuobjdump()
    if tool is None:
        return None
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            m = instance.search(ln)
            cur = counts.setdefault(key(m), Counter()) if m else None
        elif cur is not None:
            op = SASS_OP.match(ln)
            if op:
                cur[op[1].split(".")[0]] += 1
    return counts


# the SASS opcodes that issue to the FP64 and to the FP32 pipe
FP64_PIPE = ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX")
FP32_PIPE = ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "FCHK")


def image_sass_summary(counts):
    """Static SASS counts of each disk image instance: all, FP64, FP32,
    MUFU, CALL, and local loads and stores."""
    if counts is None:
        return "not measured (no cuobjdump)"
    out = []
    for name, c in sorted(counts.items()):
        fp64 = sum(c[o] for o in FP64_PIPE)
        fp32 = sum(c[o] for o in FP32_PIPE)
        out.append(f"{name}: {sum(c.values())} instructions, FP64 {fp64}, "
                   f"FP32 {fp32}, MUFU {c['MUFU']}, CALL {c['CALL']}, BRA "
                   f"{c['BRA']}, LDL {c['LDL']}, STL {c['STL']}")
    return "; ".join(out)


# kernels that each compute one function of two loaded values, for the
# SASS length of the function (op_lengths)
OP_LENGTH_SRC = r"""
#include <cuda_runtime.h>
#include <cmath>
#define K1(NAME, EXPR)                                                      \
  template <typename T>                                                     \
  __global__ void NAME(const T* in, T* out) {                               \
    const T x = in[threadIdx.x], y = in[threadIdx.x + 32];                  \
    out[threadIdx.x] = EXPR;                                                \
  }                                                                         \
  template __global__ void NAME<double>(const double*, double*);            \
  template __global__ void NAME<float>(const float*, float*);
__device__ double fr(double x) { int e; double m = frexp(x, &e); return m + e; }
__device__ float fr(float x) { int e; float m = frexpf(x, &e); return m + e; }
K1(op_base, x + y)
K1(op_div, x / y)
K1(op_sqrt, sqrt(x) + y)
K1(op_sin, sin(x) + y)
K1(op_cos, cos(x) + y)
K1(op_acos, acos(x) + y)
K1(op_log1p, log1p(x) + y)
K1(op_log, log(x) + y)
K1(op_asin, asin(x) + y)
K1(op_atan, atan(x) + y)
K1(op_atanh, atanh(x) + y)
K1(op_pow, pow(x, y))
K1(op_frexp, fr(x) + y)
K1(op_ldexp, ldexp(x, (int)y))
"""


def op_lengths():
    """{(op, 'd' or 'f'): SASS instructions} of each division, square root
    and transcendental the image kernel calls, built as the kernel is
    (sm_90a, --fmad=false, no fast math): a one-function kernel's
    instructions before its EXIT, less those of x + y (plus one for the
    binary ones, which replace the add); and {(op, t, "pipe"): n} the same
    of its instructions that issue to the FP64 pipe (t 'd': FP64_PIPE) or
    the FP32 pipe ('f': FP32_PIPE).  An out-of-line slow path after EXIT
    is not counted; one inlined and branched over is (so a length counts
    the slow path's instructions too).  {} without cuobjdump."""
    from sim5_tpu_torch import _build
    tool = _cuobjdump()
    if tool is None:
        return {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "op_lengths.cu"
    cubin = src.with_suffix(".cubin")
    src.write_text(OP_LENGTH_SRC)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-cubin", "--fmad=false", "-o",
                    str(cubin), str(src)], check=True, capture_output=True,
                   timeout=300)
    text = subprocess.run([tool, "-sass", str(cubin)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    raw, pipe, cur = {}, {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            m = re.search(r"op_(\w+?)I([df])E", ln)
            cur = (m[1], m[2]) if m else None
            if cur:
                raw[cur] = pipe[cur] = 0
        elif cur is not None:
            op = SASS_OP.match(ln)
            if op and op[1].startswith("EXIT"):
                cur = None
            elif op:
                raw[cur] += 1
                pipe[cur] += op[1].split(".")[0] in (
                    FP64_PIPE if cur[1] == "d" else FP32_PIPE)
    out = {}
    for (op, t), n in raw.items():
        if op != "base":
            one = op in ("div", "pow", "ldexp")
            out[op, t] = n - raw[("base", t)] + one
            out[op, t, "pipe"] = pipe[op, t] - pipe[("base", t)] + one
    return out


def sass_summary(counts, key):
    """Static SASS counts of one instance: all, FP32 arithmetic, MUFU
    (reciprocal, square-root and exponent seeds), branches and calls."""
    if counts is None:
        return "not measured (no cuobjdump)"
    c = counts[key]
    fp = sum(c[o] for o in ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP",
                            "FSEL", "FCHK"))
    return (f"GR={key[0]} POL={key[1]} RT={key[2]}: {sum(c.values())} "
            f"instructions, FP32 {fp} (FFMA {c['FFMA']}, FMUL {c['FMUL']}, "
            f"FADD {c['FADD']}), MUFU {c['MUFU']}, BRA {c['BRA']}, CALL "
            f"{c['CALL']}")


def march_bound(n, ray_steps, rt, model_ops=None):
    """(bound_ms, bound_by) of a march of n rays that made `ray_steps`
    trial steps in all, with transfer variant `rt`: the larger of its
    operations over the FP32 peak and its bytes over the memory rate.
    `model_ops`: the operations of one evaluation of each traced model,
    summed (model_trace's flops), in place of the torus's 19 a model."""
    per_trial = OPS_TRIAL + OPS_RT[rt]
    if model_ops is not None:
        per_trial += model_ops - 19 * rt
    t_ops = ray_steps * per_trial / H100_FP32
    t_bytes = n * (BYTES_RAY + (4 if rt else 0)) / H100_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def same_bits(outs_a, outs_b):
    """Whether two marches' outputs are bitwise equal, NaN included."""
    for a, b in zip(outs_a, outs_b):
        if (a is None) != (b is None):
            return False
        if a is None:
            continue
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            return False
    return True


def lane_use(counters):
    lane_trips, warp_trips, _ = counters
    return lane_trips / (32 * warp_trips) if warp_trips else float("nan")


def check_counters(tag, counters, steps):
    """lane-trips == sum of steps, and the last launch appended no ray."""
    lane_trips, _, appended = counters
    total = int(steps.long().sum())
    check(lane_trips == total, f"{tag}: lane-trips {lane_trips} != sum of "
          f"steps {total}")
    check(appended[-1] == 0, f"{tag}: the last launch appended "
          f"{appended[-1]} rays")


def march_timing(tensors, kw):
    """The segmented march on the same inputs: one warm-up, then
    TIMED_RUNS runs, each timed by CUDA events.  Returns (min ms, outputs
    of the first timed run, its lane counters) and whether every run gave
    bitwise the outputs of the first."""
    from sim5_tpu_torch.march import kernel_march
    kernel_march._march_cuda(*tensors, **kw)
    best, first, counters, same = float("inf"), None, None, True
    for _ in range(TIMED_RUNS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        outs = kernel_march._march_cuda(*tensors, **kw)
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
        if first is None:
            first, counters = outs, kernel_march.march_counters()
        same = same and same_bits(outs, first)
    return (best, first, counters), same


def segment_profile(tensors, kw, resident_lanes):
    """One segmented march with a CUDA event after each launch: the ms of
    each launch, the rays live at its entry, and the ms of the launches
    entered with fewer live rays than the card keeps resident lanes, than
    10% and than 1% of the rays."""
    from sim5_tpu_torch.march import kernel_march
    events = []
    kernel_march._march_cuda(*tensors, events=events, **kw)
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    n = tensors[3].shape[0]
    live = [n] + kernel_march.march_counters()[2][:-1]
    total = sum(ms)
    part = {"below resident lanes": resident_lanes,
            "below 10% of rays": n / 10, "below 1% of rays": n / 100}
    tails = {k: sum(t for t, v in zip(ms, live) if v < lim)
             for k, lim in part.items()}
    text = (f"{len(ms)} launches {total:.3f} ms; " + "; ".join(
        f"{k}: {t:.3f} ms ({t / total:.3f})" for k, t in tails.items())
        + f"; first launch {ms[0]:.3f} ms; ms per launch "
        + " ".join(f"{t:.3f}" for t in ms)
        + "; live at entry " + " ".join(str(v) for v in live))
    return text


def resident_lanes(rt):
    """Threads of march_f32<GR, no POL, rt> the card keeps resident."""
    from sim5_tpu_torch.march import kernel_march
    att = kernel_march.kernel_attributes(True, False, rt)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return att["blocks_per_sm"] * kernel_march.kernel_config()["threads"] * sms


def instance_text(rt):
    from sim5_tpu_torch.march import kernel_march
    att = kernel_march.kernel_attributes(True, False, rt)
    return (f"GR RT={rt}: {att['registers']} registers, {att['local_bytes']} "
            f"bytes local, {att['blocks_per_sm']} blocks an SM")


# nt_image<T, C> in a mangled name (T = d for double, f for float; C = 1
# for the counted instance)
IMAGE_INSTANCE = re.compile(r"nt_imageI([df])Lb([01])E")


def image_label(m):
    return ("nt_image<" + ("double" if m[1] == "d" else "float")
            + (", counted>" if m[2] == "1" else ">"))


# nt_image_jvp<T, C, K, R> in a mangled name (C slots through the
# geodesic, K in all; R = 1 for the reduction instance), named by K
JVP_INSTANCE = re.compile(
    r"nt_image_jvpI([df])Li([0-9]+)ELi([0-9]+)ELb([01])E")


def jvp_label(m):
    return ("nt_image_jvp<" + ("double" if m[1] == "d" else "float")
            + f", {m[3]}" + (", reduce>" if m[4] == "1" else ">"))


def jvp_instances_text():
    """Registers, local memory, resident blocks an SM and the block shape
    of every compiled instance of the tangent kernel."""
    from sim5_tpu_torch.render import kernel_image
    out = []
    for (dt, k), name in kernel_image.JVP_VARIANTS.items():
        for red, label in ((False, name),
                           (True, kernel_image.VJP_VARIANTS[dt, k])):
            att = kernel_image.jvp_attributes(dt, k, red)
            cfg = kernel_image.jvp_config(dt, k, red, N_IMAGE, N_IMAGE)
            out.append(f"{label}: {att['registers']} registers, "
                       f"{att['local_bytes']} bytes local, "
                       f"{att['blocks_per_sm']} blocks of {cfg['threads']} "
                       f"an SM (min {cfg['min_blocks']}), "
                       f"{cfg['chain_slots']} slot(s) through the geodesic")
    return "; ".join(out)


# builds and host-CPU references that run beside the phases: name -> future
BACKGROUND = {}


def phase_device():
    from sim5_tpu_torch._build import BUILDS
    from sim5_tpu_torch.march import kernel_march
    from sim5_tpu_torch.render import kernel_image
    name = card()
    # one nvcc for each source (and the op-length probe), all started
    # together; the tangent library (the longest build, first used by
    # phase 21) goes on building beside the phases (`tangent_build`)
    from sim5_tpu_torch.render import kernel_analytic
    t0 = time.perf_counter()
    pool = concurrent.futures.ThreadPoolExecutor(9)
    BACKGROUND["tangent"] = pool.submit(kernel_image._jvp_lib)
    # the analytic kernels' counted instances (phase 28) build beside the
    # phases too
    BACKGROUND["analytic_counted"] = [
        pool.submit(kernel_analytic._lib, f"{n}_counted")
        for n in ("crossing_map", "volume_seed")]
    futs = [pool.submit(kernel_march._lib), pool.submit(kernel_image._lib),
            pool.submit(op_lengths),
            pool.submit(kernel_analytic._lib, "crossing_map"),
            pool.submit(kernel_analytic._lib, "volume_seed"),
            pool.submit(kernel_analytic._ops_lib)]
    lengths = [f.result() for f in futs][2]
    pool.shutdown(wait=False)
    build_s = time.perf_counter() - t0
    b, bi = BUILDS["march"], BUILDS["disk_image"]
    cfg = kernel_march.kernel_config()
    image_att = "; ".join(
        f"{names[dt]}: {att['registers']} registers, {att['local_bytes']} "
        f"bytes local, {att['blocks_per_sm']} blocks an SM"
        for counted, names in ((False, kernel_image.VARIANTS),
                               (True, kernel_image.COUNTED))
        for dt, att in ((dt, kernel_image.kernel_attributes(dt, counted))
                        for dt in names))
    image_sass = sass_counts(bi["path"], IMAGE_INSTANCE, image_label)
    print(f"phase 1 device: {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | builds {build_s:.2f} s together: march "
          f"{b['seconds']:.2f} s cached={b['cached']}, disk_image "
          f"{bi['seconds']:.2f} s cached={bi['cached']} (disk_image_jvp "
          f"building beside the phases) | {cfg} | "
          + "; ".join(instance_text(rt) for rt in range(3))
          + f" | ptxas: {ptxas_summary(b['log'])} | SASS (static): "
          + "; ".join(sass_summary(sass_counts(b["path"]), (1, 0, rt))
                      for rt in range(3))
          + f" | image: {kernel_image.kernel_config()}; {image_att} | image "
          f"ptxas: " + ptxas_summary(bi["log"], IMAGE_INSTANCE, image_label)
          + f" | image SASS (static): {image_sass_summary(image_sass)} | SASS "
          f"lengths (f64 d, f32 f; all instructions / those of the FP "
          f"pipe): "
          + (", ".join(f"{k[0]}_{k[1]} {n}/{lengths[(*k, 'pipe')]}"
                       for k, n in sorted(lengths.items()) if len(k) == 2)
             or "not measured (no cuobjdump)")
          + f" | analytic kernels: {analytic_build_text()}", flush=True)
    return name, lengths


# the analytic kernels' entry functions in the ptxas report (their passes)
ANALYTIC_INSTANCE = re.compile(
    r"(crossing_classify)|(crossing_hits)|seed_geometryI([df])Lb([01])E|"
    r"seed_azimuthI([df])")


def analytic_label(m):
    t = {"d": "double", "f": "float"}
    return ("crossing_classify<double>" if m[1] else
            "crossing_hits<double>" if m[2] else
            f"seed_geometry<{t[m[3]]}, {'true' if m[4] == '1' else 'false'}>"
            if m[3] else f"seed_azimuth<{t[m[5]]}>")


def analytic_build_text():
    """The analytic libraries' builds, configs, each instance's registers,
    local memory and resident blocks, and ptxas' registers, stack and
    spills."""
    from sim5_tpu_torch._build import BUILDS
    from sim5_tpu_torch.render import kernel_analytic as ka
    parts = [f"{n} {BUILDS[n]['seconds']:.2f} s cached={BUILDS[n]['cached']}"
             for n in ("crossing_map", "volume_seed", "analytic_ops")]
    return (", ".join(parts) + f" | {ka.MAX_ORDERS} orders a launch at "
            f"most | {analytic_attributes_text()}")


def analytic_attributes_text():
    """Each analytic pass's registers, local memory and resident blocks,
    and the compiler's registers, stack and spills of each."""
    from sim5_tpu_torch._build import BUILDS
    from sim5_tpu_torch.render import kernel_analytic as ka
    atts = "; ".join(
        f"{v}: {att['registers']} registers, {att['local_bytes']} bytes "
        f"local, {att['blocks_per_sm']} blocks of {att['threads']} an SM"
        for v, att in ((v, ka.kernel_attributes(v)) for v in ka.LAUNCHES))
    reports = "; ".join(
        ptxas_summary(BUILDS[n]["log"], ANALYTIC_INSTANCE, analytic_label)
        for n in ("crossing_map", "volume_seed") if n in BUILDS)
    return f"{atts} | ptxas: {reports}"


def tangent_build():
    """Waits for the tangent library phase 1 started, checks the slots it
    was compiled with and prints its build and registers."""
    from sim5_tpu_torch._build import BUILDS
    from sim5_tpu_torch.render import kernel_image
    t0 = time.perf_counter()
    BACKGROUND.pop("tangent").result()
    wait_s = time.perf_counter() - t0
    bj = BUILDS["disk_image_jvp"]
    compiled = kernel_image.jvp_backward_slots()
    check(compiled == (kernel_image.JVP_SLOTS[-1],
                       len(kernel_image.CHAIN_COLUMNS)),
          f"the tangent library's backward slots {compiled} are not "
          f"kernel_image.JVP_SLOTS {kernel_image.JVP_SLOTS} with "
          f"CHAIN_COLUMNS {kernel_image.CHAIN_COLUMNS}")
    print(f"phase 1 (tangent library, built beside phases 2-20): "
          f"disk_image_jvp {bj['seconds']:.2f} s cached={bj['cached']}, "
          f"waited {wait_s:.2f} s | tangent kernel: {jvp_instances_text()} | "
          f"tangent ptxas: " + ptxas_summary(bj["log"], JVP_INSTANCE,
                                             jvp_label), flush=True)


def phase_compare(dev):
    from sim5_tpu_torch.march import (raytrace_prepare, raytrace_kernel,
                                      raytrace_reference, RTOPT_FLAT,
                                      RTOPT_POLARIZATION)
    worst = dict(eq=1.0, rel=0.0, dth=0.0, df=0.0)
    for a in (0.3, 0.9):
        for variant in ("gr", "gr+pol", "flat"):
            pol, flat = variant == "gr+pol", variant == "flat"
            x, k, f0 = zamo_rays(N_CMP, a, seed=0, dtype=torch.float32,
                                 device=dev, flat=flat, pol=pol)
            opts = (RTOPT_POLARIZATION if pol else 0) | (RTOPT_FLAT if flat
                                                         else 0)
            st0 = raytrace_prepare(a, x, k, f=f0, precision=0.01,
                                   options=opts)
            kw = dict(r_max=50.0, max_steps=300)
            st_k, _ = raytrace_kernel(st0, **kw)
            st_p, _ = raytrace_reference(st0, **kw)
            torch.cuda.synchronize()
            eq, rel, dth, df, _ = compare(st_k, st_p, pol)
            tag = f"a={a} {variant}"
            check(eq > 0.9, f"{tag}: equal steps on only {eq:.4f} of rays")
            check(rel < 1e-3, f"{tag}: relative dr {rel:.2e} >= 1e-3")
            check(dth < 1e-3, f"{tag}: dtheta {dth:.2e} >= 1e-3")
            check(df < 2e-3, f"{tag}: |df| {df:.2e} >= 2e-3")
            worst = dict(eq=min(worst["eq"], eq), rel=max(worst["rel"], rel),
                         dth=max(worst["dth"], dth), df=max(worst["df"], df))
    print(f"phase 2 kernel vs plain ({N_CMP} rays, a in (0.3, 0.9), gr / "
          f"gr+pol / flat, r_max 50, 300 steps): equal steps >= "
          f"{worst['eq']:.4f} (gate > 0.9), rel dr <= {worst['rel']:.3e} "
          f"(gate 1e-3), dtheta <= {worst['dth']:.3e} (gate 1e-3), "
          f"|df| <= {worst['df']:.3e} (gate 2e-3)", flush=True)
    return worst


def drift_gates(tag, st, act, r_max, raytrace_error):
    r_fin = st.x[..., 1].double().cpu().numpy()
    done = ~act.cpu().numpy()
    drift = raytrace_error(st).double().cpu().numpy()
    nan_frac = float((~np.isfinite(r_fin)).mean())
    esc = done & (r_fin >= r_max) & np.isfinite(drift)
    check(nan_frac == 0.0, f"{tag}: NaN fraction {nan_frac:.2e}")
    check(done.mean() > 0.99, f"{tag}: only {done.mean():.4f} finished")
    check(esc.mean() > 0.99, f"{tag}: only {esc.mean():.4f} escaped")
    med = float(np.median(drift[esc]))
    p99 = float(np.percentile(drift[esc], 99))
    check(med <= 1e-4, f"{tag}: median Carter drift {med:.3e} > 1e-4")
    check(p99 <= 1e-3, f"{tag}: p99 Carter drift {p99:.3e} > 1e-3")
    return dict(nan_frac=nan_frac, finished=float(done.mean()),
                escaped=float(esc.mean()), drift_median=med, drift_p99=p99)


def main_path(n, dtype, dev, engine):
    from sim5_tpu_torch.march import raytrace_prepare
    x, k, _ = zamo_rays(n, MAIN["a"], SEED_MAIN, dtype, dev, outward=1.0)
    st0 = raytrace_prepare(MAIN["a"], x, k, precision=MAIN["precision"])
    return engine(st0, r_max=MAIN["r_max"], max_steps=MAIN["max_steps"])


def phase_main(dev):
    from sim5_tpu_torch.march import (raytrace_kernel, raytrace_error,
                                      kernel_march)
    kernel_march.LAUNCHES.update(dict.fromkeys(kernel_march.LAUNCHES, 0))
    t0 = time.perf_counter()
    st, act = main_path(N_MAIN, torch.float32, dev, raytrace_kernel)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(kernel_march.LAUNCHES)
    launches = counts["march_f32"]
    check(launches >= 1, "main path launched the march kernel 0 times")
    counters = kernel_march.march_counters()
    check_counters("main path", counters, st.steps)
    g = drift_gates("main path", st, act, MAIN["r_max"], raytrace_error)
    steps = int(st.steps.long().sum())
    print(f"phase 3 main path ({N_MAIN} rays f32, a=0.9, r_max 500, 4000 "
          f"steps): LAUNCHES={counts} nan_frac={g['nan_frac']} finished="
          f"{g['finished']:.5f} escaped={g['escaped']:.5f} drift median="
          f"{g['drift_median']:.3e} p99={g['drift_p99']:.3e} ray-steps="
          f"{steps} mean steps={steps / N_MAIN:.1f} max steps="
          f"{int(st.steps.max())} lane-trips={counters[0]} (== sum of "
          f"steps) warp-trips={counters[1]} lane use="
          f"{lane_use(counters):.4f} wall={secs:.3f} s", flush=True)
    return counts, g


def phase_f64(dev):
    from sim5_tpu_torch.march import raytrace, raytrace_error
    t0 = time.perf_counter()
    st, act = main_path(N_F64, torch.float64, dev, raytrace)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    g = drift_gates("f64 engine", st, act, MAIN["r_max"], raytrace_error)
    print(f"phase 4 f64 torch engine ({N_F64} rays): nan_frac="
          f"{g['nan_frac']} finished={g['finished']:.5f} escaped="
          f"{g['escaped']:.5f} drift median={g['drift_median']:.3e} p99="
          f"{g['drift_p99']:.3e} steps={int(st.steps.max())} "
          f"wall={secs:.2f} s", flush=True)
    return g


def timing_report(tag, n, rt, timing, same, plain_outs, plain_ms,
                  compare_fn, model_ops=None):
    """Gate and describe one march timing: returns (text, row)."""
    check(same, f"{tag}: two runs of the segmented march are not bitwise "
          f"equal")
    ms, outs, counters = timing
    check_counters(tag, counters, outs[5])
    ray_steps = int(outs[5].long().sum())
    bound_ms, bound_by = march_bound(n, ray_steps, rt, model_ops)
    row = dict(ms=ms, plain_ms=plain_ms, max_abs_err=compare_fn(outs,
                                                                plain_outs),
               bound_ms=bound_ms, bound_by=bound_by)
    text = (f"segmented {ms:.3f} ms (min of {TIMED_RUNS}) "
            f"{ray_steps / (ms * 1e-3):.4e} ray-steps/s lane use "
            f"{lane_use(counters):.4f} ({bound_ms / ms:.3f} of bound) | bound "
            f"{bound_ms:.3f} ms ({bound_by}) | all {TIMED_RUNS} timed runs "
            f"bitwise equal, steps equal on every ray | plain "
            f"{plain_ms:.3f} ms")
    return text, row


def phase_timing(dev, name):
    """The segmented march (CUDA events, min of TIMED_RUNS) and the plain
    version once (it is host-launch-bound and takes tens of seconds) on
    the main path's packed inputs.  Holds the runs bitwise equal and the
    kernel against the plain version."""
    from sim5_tpu_torch.march import raytrace_prepare, kernel_march
    x, k, _ = zamo_rays(N_MAIN, MAIN["a"], SEED_MAIN, torch.float32, dev,
                        outward=1.0)
    st0 = raytrace_prepare(MAIN["a"], x, k, precision=MAIN["precision"])
    tensors, scalars = kernel_march._pack(st0, MAIN["r_max"],
                                          MAIN["max_steps"], 1e-2, None)
    timing, same = march_timing(tensors, scalars)
    ms_p, out_p = timed(kernel_march.march_reference, tensors, scalars)
    st_p, _ = kernel_march._unpack(st0, out_p)
    st_k, _ = kernel_march._unpack(st0, timing[1])
    eq, rel, _, _, _ = compare(st_k, st_p, False)
    check(eq > 0.9, f"main shape: equal steps on only {eq:.4f} of rays")
    check(rel < 1e-3, f"main shape: relative dr {rel:.3e} >= 1e-3")

    def max_dr(outs, plain):
        return compare(kernel_march._unpack(st0, outs)[0], st_p, False)[4]

    text, row = timing_report("main shape", N_MAIN, 0, timing, same, out_p,
                              ms_p, max_dr)
    segs = segment_profile(tensors, scalars, resident_lanes(0))
    print(f"phase 5 timing ({N_MAIN} rays f32, a=0.9, r_max 500; {name}): "
          f"{text} | kernel vs plain: equal steps {eq:.4f} rel dr "
          f"{rel:.3e} | segments: {segs}", flush=True)
    return row


def timed(fn, tensors, scalars):
    """(ms, outputs) of one run of fn(*tensors, **scalars), by CUDA
    events."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    outs = fn(*tensors, **scalars)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), outs


def torus(alpha0=1.0):
    """Example 11's torus emissivity (alpha0 = 1) or its absorption
    alpha0 * j (None for alpha0 = 0, the thin limit)."""
    from sim5_tpu_torch.march.emission import GaussianSource
    if alpha0 == 0.0:
        return None
    return GaussianSource(amp=alpha0, center=8.0, inv_width=1.0 / 1.5,
                          inv_height=1.0 / 1.5, cylindrical=True)


def volume_seed_f32(npix, dev, cfg=VOL):
    """The f64 analytic seed of a volume configuration at npix^2, cast to
    f32 as the kernel route does, and the valid mask, as a flat batch of
    npix^2 rays."""
    from sim5_tpu_torch.render import lightcurve
    kw = {k: cfg[k] for k in ("rmax", "r_start", "precision",
                              "axisymmetric")}
    st, ok = lightcurve._volume_seed(cfg["a"], cfg["incl"], 0.0, npix=npix,
                                     device=dev, **kw)
    st = lightcurve._as_f32(st)
    flat = {f: getattr(st, f).flatten(0, 1) for f in (
        "x", "k", "f", "a", "E", "Q", "kt", "error", "steps", "step_epsilon",
        "step_epsilon0")}
    return st._replace(**flat), ok.flatten()


def compare_transfer(out_k, out_p, st0):
    """Kernel vs plain transfer march: (equal-steps share, max rel dr over
    equal finite rays, max |dI| over equal rays, peak I of the plain)."""
    from sim5_tpu_torch.march import kernel_march
    st_k, _, I_k = kernel_march._unpack(st0, out_k)
    st_p, _, I_p = kernel_march._unpack(st0, out_p)
    eq, rel, _, _, _ = compare(st_k, st_p, False)
    same = (st_k.steps == st_p.steps).cpu().numpy()
    dI = (I_k.double() - I_p.double()).abs().cpu().numpy()[same]
    return eq, rel, float(dI.max()), float(I_p.double().max())


def plain_together(parts, scalars):
    """The plain march of several batches of rays that share the march's
    scalars, each (tensors, emissivity, absorption), in one call: each
    batch's outputs.  The plain march costs its steps, one launch an op,
    not its rays, so one call costs about what one batch does alone.  A
    ray's arithmetic is elementwise: each model runs on every ray and
    torch.where keeps it on its own batch's rays, and a thin batch runs
    as a thick one with no absorption (tau stays 0, e^-0 is 1 and s_eff
    is dl, so I gains j dl as in the thin branch).  So each ray gives the
    bits it gives alone; phase 27 checks that on the card."""
    from sim5_tpu_torch.march import kernel_march
    sizes = [t[3].shape[0] for t, _, _ in parts]
    tensors = tuple(torch.cat([t[i] for t, _, _ in parts], -1).contiguous()
                    for i in range(5))
    bounds = np.cumsum([0] + sizes).tolist()

    def chosen(models):
        masks = {}
        for fn, lo, hi in zip(models, bounds, bounds[1:]):
            if fn is not None:
                mask = masks.get(fn)
                if mask is None:
                    mask = masks[fn] = torch.zeros_like(tensors[4])
                mask[lo:hi] = True

        def model(t, r, m, phi):
            out = torch.zeros_like(r)
            for fn, mask in masks.items():
                out = torch.where(mask, fn(t, r, m, phi), out)
            return out
        return model if masks else None

    thick = any(ab is not None for _, _, ab in parts)
    outs = kernel_march.march_reference(
        *tensors, **scalars, emissivity=chosen([em for _, em, _ in parts]),
        absorption=chosen([ab for _, _, ab in parts]) if thick else None)
    return [tuple(None if v is None else v[..., lo:hi] for v in outs)
            for lo, hi in zip(bounds, bounds[1:])]


def photon_orbits(a):
    """Radii of the prograde and retrograde circular photon orbits of spin
    a (Bardeen, Press & Teukolsky 1972): every spherical photon orbit lies
    between them."""
    return tuple(2.0 * (1.0 + math.cos(2.0 / 3.0 * math.acos(s * a)))
                 for s in (-1.0, 1.0))


def compare_off_orbit(out_k, out_p, st0, a):
    """Kernel vs plain transfer march without the rays circling the photon
    orbits: (max |dI| over the other rays with equal step counts, the
    rays circling, max |dI| over those).  A ray circles when either march
    leaves it still marching at the step cap inside the photon orbits'
    band.  There the geodesic flow is unstable, so two f32 marches of one
    ray part within its steps whatever the model; their step counts are
    equal only because both hit the cap."""
    from sim5_tpu_torch.march import kernel_march
    st_k, act_k, I_k = kernel_march._unpack(st0, out_k)
    st_p, act_p, I_p = kernel_march._unpack(st0, out_p)
    r_lo, r_hi = photon_orbits(a)

    def inside(st):
        r = st.x[..., 1]
        return (r >= r_lo) & (r <= r_hi)

    circling = (act_k & inside(st_k)) | (act_p & inside(st_p))
    same = (st_k.steps == st_p.steps) & ~circling
    dI = (I_k.double() - I_p.double()).abs()
    return (float(dI[same].max()) if bool(same.any()) else math.nan,
            int(circling.sum()),
            float(dI[circling].max()) if bool(circling.any()) else 0.0)


@contextlib.contextmanager
def launch_events():
    """CUDA events around every march kernel launch made in the block."""
    from sim5_tpu_torch.march import kernel_march
    launch, events = kernel_march._march_cuda, []

    def bracketed(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        outs = launch(*args, **kw)
        e1.record()
        events.append((e0, e1))
        return outs

    kernel_march._march_cuda = bracketed
    try:
        yield events
    finally:
        kernel_march._march_cuda = launch


TRACED_CMP = ("corona", "corona thick", "spiral", "spiral thick")


def phase_transfer_compare(dev):
    """The transfer variants vs their plain version on the seeded rays of
    a 64^2 image, thin and thick.  The same plain call marches phase 27's
    corona and spiral pairs on the 64^2 seeds of their configurations and
    on the torus's 512^2 seed (`plain_together`: it costs its steps, not
    its rays): returns those seeds and outputs for phase 27."""
    from sim5_tpu_torch.march import kernel_march
    st0, ok = volume_seed_f32(N_VOL_CMP, dev)
    tensors, scalars = kernel_march._pack(
        st0, 1.2 * VOL["r_start"], VOL["max_steps"], 1e-2, ok)
    small = {True: (st0, tensors)}
    cfg = dict(VOL, axisymmetric=False)
    st0n, okn = volume_seed_f32(N_VOL_CMP, dev, cfg)
    small[False] = (st0n, kernel_march._pack(
        st0n, 1.2 * cfg["r_start"], cfg["max_steps"], 1e-2, okn)[0])
    st0b, okb = volume_seed_f32(N_VOL_PIX, dev)
    big, sb = kernel_march._pack(st0b, 1.2 * VOL["r_start"],
                                 VOL["max_steps"], 1e-2, okb)
    check(sb == scalars, f"the {N_VOL_PIX}^2 seed marches with other "
          f"scalars: {sb} vs {scalars}")
    pairs = traced_pairs()
    batches = [(tensors, torus(), torus(alpha0)) for alpha0 in ALPHA0]
    for p in TRACED_CMP:
        batches += [(small[p.startswith("corona")][1], *pairs[p]),
                    (big, *pairs[p])]
    n_rays = sum(t[3].shape[0] for t, _, _ in batches)
    t0 = time.perf_counter()
    plains = plain_together(batches, scalars)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    shared = dict(small=small, big=(st0b, big), scalars=scalars,
                  plain_s=plain_s, plains={
        p: plains[2 + 2 * n: 4 + 2 * n] for n, p in enumerate(TRACED_CMP)})
    parts = []
    for alpha0, out_p in zip(ALPHA0, plains):
        kw = dict(scalars, emissivity=torus(), absorption=torus(alpha0))
        out_k = kernel_march._march_cuda(*tensors, **kw)
        torch.cuda.synchronize()
        eq, rel, dI, peak = compare_transfer(out_k, out_p, st0)
        tag = f"alpha0={alpha0}"
        check(peak > 0.0, f"{tag}: plain peak I is {peak}")
        check(eq > 0.9, f"{tag}: equal steps on only {eq:.4f} of rays")
        check(rel < 1e-3, f"{tag}: relative dr {rel:.3e} >= 1e-3")
        check(dI <= 1e-3 * peak, f"{tag}: |dI| {dI:.3e} > 1e-3 of peak "
              f"{peak:.4e}")
        parts.append(f"{tag}: equal steps {eq:.4f} rel dr {rel:.3e} |dI| "
                     f"{dI:.3e} ({dI / peak:.3e} of peak {peak:.4e})")
    print(f"phase 6 transfer kernel vs plain ({N_VOL_CMP}^2 seeded rays, "
          f"GR; gates: equal steps > 0.9, rel dr < 1e-3, |dI| <= 1e-3 of "
          f"peak): " + " | ".join(parts) + f" | the plain march of these "
          f"and of phase 27's four pairs on their {N_VOL_CMP}^2 seeds and "
          f"the {N_VOL_PIX}^2 seed ({len(batches)} batches, {n_rays} rays) "
          f"in one call: {plain_s:.1f} s host clock",
          flush=True)
    return shared


def volume_kw(cfg, npix):
    """volume_image's keywords of a volume configuration at npix^2."""
    return dict(npix=npix, rmax=cfg["rmax"], r_start=cfg["r_start"],
                max_steps=cfg["max_steps"], precision=cfg["precision"],
                axisymmetric=cfg["axisymmetric"])


def volume_main(dev, cfg=VOL, source=None):
    """A volume main path: volume_image(engine="kernel") at 512^2 of
    `source` (alpha0 -> model or None; the torus by default), thin then
    thick, through the entry point a user calls, each with the launch
    counts set to 0 just before it.  Returns (images, launches a
    variant, march ms a variant, text of each, text of the thick-thin
    gate)."""
    from sim5_tpu_torch.march import kernel_march
    from sim5_tpu_torch.march.emission import is_family
    from sim5_tpu_torch.render import kernel_analytic, lightcurve, volume_image
    source = source or torus
    images, launches, march, parts = {}, {}, {}, []
    seed_v = seed_name(cfg)
    for alpha0 in ALPHA0:
        kernel_march.LAUNCHES.update(dict.fromkeys(kernel_march.LAUNCHES, 0))
        reset_analytic()
        t0 = time.perf_counter()
        with launch_events() as events:
            I = volume_image(cfg["a"], cfg["incl"], source(),
                             engine="kernel", absorption_fn=source(alpha0),
                             **volume_kw(cfg, N_VOL_PIX))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernel_march.LAUNCHES)
        seeds = analytic_launches()
        check(seeds[seed_v] == 1, f"alpha0={alpha0}: the image's seed "
              f"launched {launched(seeds)}, not {seed_v} once")
        launches[seed_v] = seeds[seed_v]
        for pv in kernel_analytic.PASSES[seed_v]:
            launches[pv] = seeds[pv]
        march_ms = sum(e0.elapsed_time(e1) for e0, e1 in events)
        traced = not is_family(source(), source(alpha0))
        variant = kernel_march.VARIANTS[(1 if alpha0 == 0.0 else 2)
                                        + (2 if traced else 0)]
        check(counts[variant] >= 1,
              f"alpha0={alpha0}: the image launched {variant} 0 times")
        launches[variant] = counts[variant]
        march[variant] = march_ms
        # the seed alone, warm, on the host clock
        t0 = time.perf_counter()
        lightcurve._volume_seed(
            cfg["a"], cfg["incl"], 0.0, npix=N_VOL_PIX, rmax=cfg["rmax"],
            r_start=cfg["r_start"], precision=cfg["precision"],
            axisymmetric=cfg["axisymmetric"], device=dev)
        torch.cuda.synchronize()
        seed_s = time.perf_counter() - t0
        Id = I.double()
        peak = float(Id.max())
        check(tuple(I.shape) == (N_VOL_PIX, N_VOL_PIX),
              f"image shape {tuple(I.shape)}")
        check(bool(torch.isfinite(Id).all()), f"alpha0={alpha0}: non-finite I")
        check(bool((Id >= 0.0).all()), f"alpha0={alpha0}: negative I")
        check(peak > 0.0, f"alpha0={alpha0}: peak I {peak}")
        images[alpha0] = Id
        parts.append(f"alpha0={alpha0}: {variant} LAUNCHES={counts[variant]} "
                     f"(all {counts}), {seed_v} {seeds[seed_v]}, flux {float(Id.sum()):.6e} peak "
                     f"{peak:.6e} | image {wall:.3f} s (host clock), march "
                     f"{march_ms:.3f} ms (CUDA events), seed alone "
                     f"{seed_s:.3f} s (host clock)")
    thin, thick = images[0.0], images[1.0]
    peak = float(thin.max())
    excess = float((thick - thin).max())
    # Absorption only removes light, but the thick branch of the Pallas body
    # (which the kernel follows) takes s_eff = (1 - expf(-dtau)) / alpha in
    # f32: expf's error of up to 2 ulp near 1 lets s_eff exceed dl by up to
    # 2^-23 / alpha on an accepted step with dtau > 1e-6, so a thick pixel
    # may exceed its thin one by 2^-23 j / alpha a step (j / alpha =
    # 1 / alpha0 for the torus and the spot), on at most max_steps steps.
    allow = 1e-6 * peak + cfg["max_steps"] * 2.0 ** -23 / ALPHA0[1]
    check(excess <= allow, f"thick exceeds thin by {excess:.3e} > "
          f"{allow:.3e} (1e-6 of peak {peak:.4e} + f32 rounding of s_eff)")
    check(float(thick.sum()) < float(thin.sum()),
          "thick total flux is not below thin")
    gate = (f"thick - thin <= {excess:.3e} = {excess / peak:.3e} of peak "
            f"(gate {allow:.3e}: 1e-6 of peak + max_steps 2^-23 / alpha0), "
            f"flux ratio thick/thin "
            f"{float(thick.sum()) / float(thin.sum()):.5f}")
    return images, launches, march, parts, gate


def phase_volume_main(dev):
    """The volume path's main path for example 11's torus: returns the
    launches and the images."""
    images, launches, march, parts, gate = volume_main(dev)
    print(f"phase 7 volume main path ({N_VOL_PIX}^2, a={VOL['a']}, incl "
          f"{math.degrees(VOL['incl']):.0f}, r_start {VOL['r_start']}, "
          f"{VOL['max_steps']} steps, f64 seed -> f32 kernel): "
          + " | ".join(parts) + f" | {gate}", flush=True)
    return launches, images


def volume_loop(dev, npix, alpha0, cfg=VOL, source=None):
    """The kernel route against the f64 loop engine at npix^2 for `source`
    (the torus by default) at alpha0, at the JAX package's gate for that
    engine (test_pallas_march.py): returns the text."""
    from sim5_tpu_torch.render import volume_image
    source = source or torus
    kw = volume_kw(cfg, npix)
    t0 = time.perf_counter()
    I_l = volume_image(cfg["a"], cfg["incl"], source(), engine="loop",
                       absorption_fn=source(alpha0), **kw).double()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    I_k = volume_image(cfg["a"], cfg["incl"], source(), engine="kernel",
                       absorption_fn=source(alpha0), **kw).double()
    peak = float(I_l.max())
    err = float((I_k - I_l).abs().max())
    check(peak > 0.0, f"alpha0={alpha0}: loop peak I {peak}")
    check(err <= 2e-2 * peak, f"alpha0={alpha0}: kernel vs f64 loop "
          f"{err / peak:.3e} of peak > 2e-2")
    return (f"alpha0={alpha0}: max |dI| {err:.3e} = {err / peak:.3e} of peak "
            f"{peak:.4e} (f64 loop {secs:.2f} s)")


def phase_volume_loop(dev):
    """The torus's thin kernel route against the f64 loop engine (phase 14
    holds the orbiting spot's thick one)."""
    print(f"phase 8 kernel route vs f64 loop engine ({N_VOL_LOOP_TORUS}^2; "
          f"gate 2e-2 of peak): " + volume_loop(dev, N_VOL_LOOP_TORUS, 0.0),
          flush=True)


def phase_volume_timing(dev, name):
    """Phase 5's timing for the transfer variants at 512^2, on the packed
    inputs of the volume main path, and their plain version once.  Returns
    the rows, the kernel's outputs and the plain version's, by rt."""
    from sim5_tpu_torch.march import kernel_march
    st0, ok = volume_seed_f32(N_VOL_PIX, dev)
    tensors, scalars = kernel_march._pack(
        st0, 1.2 * VOL["r_start"], VOL["max_steps"], 1e-2, ok)
    n = N_VOL_PIX * N_VOL_PIX
    out, outs, plains, parts = {}, {}, {}, []
    for alpha0 in ALPHA0:
        rt = 1 if alpha0 == 0.0 else 2
        tag = f"512^2 alpha0={alpha0}"
        kw = dict(scalars, emissivity=torus(), absorption=torus(alpha0))
        timing, same = march_timing(tensors, kw)
        ms_p, out_p = timed(kernel_march.march_reference, tensors, kw)
        eq, rel, dI, peak = compare_transfer(timing[1], out_p, st0)
        check(eq > 0.9, f"{tag}: equal steps {eq:.4f}")
        check(dI <= 1e-3 * peak, f"{tag}: |dI| {dI:.3e} > 1e-3 of peak "
              f"{peak:.4e}")

        def max_dI(outs, plain):
            return compare_transfer(outs, plain, st0)[2]

        text, row = timing_report(tag, n, rt, timing, same, out_p, ms_p,
                                  max_dI)
        out[rt], outs[rt], plains[rt] = row, timing[1], out_p
        steps = timing[1][5]
        parts.append(
            f"alpha0={alpha0}: {text} | ray-steps {int(steps.long().sum())} "
            f"(mean {float(steps.double().mean()):.1f}, max "
            f"{int(steps.max())}) | kernel vs plain: equal steps {eq:.4f} "
            f"|dI| {dI:.3e} | segments: "
            + segment_profile(tensors, kw, resident_lanes(rt)))
    print(f"phase 9 transfer timing ({N_VOL_PIX}^2 rays f32; {name}): "
          + " | ".join(parts), flush=True)
    return out, outs, plains


def nt_disk(dtype, dev, a=NT["a"]):
    """nt_setup of the headline frame's disk (spin `a`), in `dtype` on the
    card, from scalars filled on the device (no host copy)."""
    from sim5_tpu_torch.disk import nt_setup
    return nt_setup(*(torch.full((), v, dtype=dtype, device=dev)
                      for v in (NT["M"], a, NT["mdot"], NT["alpha"])))


def sweep_spins():
    """The spin sweep's spins, a = 0.998 - 2e-4 k, as Python floats."""
    return [NT["a"] - 2e-4 * k for k in range(N_SWEEP)]


def nt_disks(dtype, dev, spins):
    """nt_setup over a vector of spins: one disk of (n,) tensors, the
    headline frame's disk at each spin."""
    from sim5_tpu_torch.disk import nt_setup
    n = len(spins)
    return nt_setup(*(torch.full((n,), v, dtype=dtype, device=dev)
                      for v in (NT["M"],)),
                    torch.tensor(spins, dtype=torch.float64,
                                 device=dev).to(dtype),
                    *(torch.full((n,), v, dtype=dtype, device=dev)
                      for v in (NT["mdot"], NT["alpha"])))


def bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def image_err(got, want):
    """(max |got - want| over the pixels both hit / peak of want, footprint
    mismatches, max |got - want| over those pixels) of two images."""
    got, want = got.double(), want.double()
    both = (got > 0) & (want > 0)
    diff = (got - want).abs()[both]
    d = float(diff.max()) if diff.numel() else 0.0
    return d / float(want.max()), int(((got > 0) != (want > 0)).sum()), d


def check_image(tag, imf, img, npix, batch=()):
    check(tuple(imf.shape) == tuple(batch) + (npix, npix) == tuple(img.shape),
          f"{tag}: image shape {tuple(imf.shape)}")
    check(bool(torch.isfinite(imf).all() and torch.isfinite(img).all()),
          f"{tag}: non-finite pixels")
    check(bool((imf >= 0).all() and (img >= 0).all()),
          f"{tag}: negative pixels")
    check(float(imf.max()) > 0.0, f"{tag}: dark image")


def phase_image_golden(dev):
    """The f64 kernel and the f64 plain version on the card against the C
    goldens at 128^2: 1e-6 of the peak with the golden's footprint."""
    from sim5_tpu_torch.render import kernel_image, render_disk_image
    from sim5_tpu_torch.render.image import render_disk_image_reference
    golden = pathlib.Path(__file__).resolve().parent / "tests" / "golden"
    kernel_image.LAUNCHES.update(dict.fromkeys(kernel_image.LAUNCHES, 0))
    errs, parts = {}, []
    for tag, fname, a, inc in (("a0", "image128_a0.txt", 0.0, 60.0),
                               ("a998", "image128_a998.txt", 0.998, 80.0)):
        d = np.loadtxt(golden / fname)
        ref = torch.as_tensor(d[:, 2].reshape(N_GOLDEN, N_GOLDEN))
        disk = nt_disk(torch.float64, dev, a=a)
        for route, fn in (("kernel", render_disk_image),
                          ("plain", render_disk_image_reference)):
            imf, img = fn(disk, math.radians(inc), N_GOLDEN, N_GOLDEN)
            check_image(f"{tag} {route}", imf, img, N_GOLDEN)
            imf = imf.cpu()
            err = float((imf - ref).abs().max() / ref.max())
            mismatch = int(((imf > 0) != (ref > 0)).sum())
            check(err <= 1e-6, f"golden {tag} {route}: {err:.3e} of peak > "
                  f"1e-6")
            check(mismatch == 0, f"golden {tag} {route}: footprint differs "
                  f"on {mismatch} pixels")
            if route == "kernel":
                errs[tag] = err
            parts.append(f"{tag} {route} {err:.3e}")
    counts = dict(kernel_image.LAUNCHES)
    want = {k: 2 if k in ("nt_frames<double>", "nt_image<double>") else 0
            for k in counts}
    check(counts == want, f"golden renders launched {counts}, not 2 f64 "
          f"kernel launches")
    print(f"phase 10 disk image vs C goldens ({N_GOLDEN}^2 f64 on the card; "
          f"gate 1e-6 of peak, identical footprint): "
          + " | ".join(parts) + f" | ondevice_f64_err_a0={errs['a0']:.3e} "
          f"ondevice_f64_err_a998={errs['a998']:.3e} | LAUNCHES={counts}",
          flush=True)
    return errs


def check_image_counters(tag, c, n, image_g):
    """The counters of one launch against its image: every pixel counted
    once by type, status and hit order, and the shaded pixels are those
    with g > 0."""
    lanes = {k: v[1] for k, v in c.items()}
    hits = int((image_g > 0).sum())
    check(lanes["pixels"] == n, f"{tag}: counted {lanes['pixels']} pixels, "
          f"not {n}")
    for group in ("type_", "status_"):
        total = sum(v for k, v in lanes.items() if k.startswith(group))
        check(total == n, f"{tag}: {group}* counters sum to {total}, not {n}")
    check(lanes["hit0"] + lanes["hit1"] + lanes["dark"] == n,
          f"{tag}: hit0 + hit1 + dark != {n}")
    check(lanes["shade"] == lanes["hit0"] + lanes["hit1"] == hits,
          f"{tag}: shaded {lanes['shade']}, hits {lanes['hit0']} + "
          f"{lanes['hit1']}, pixels with g > 0 {hits}")
    for stage, parts in (("rad0", ("rad0_RR", "rad0_RC", "rad0_CC")),
                         ("order1", ("rad1_RR", "rad1_RC", "rad1_CC"))):
        check(lanes[stage] == sum(lanes[p] for p in parts),
              f"{tag}: {stage} != the sum of {parts}")


def counters_text(c):
    """The stages' warps, lanes and lane use, and the nonzero classes."""
    stages = ("pixels", "rf_R", "K_R", "rad0", "order1", "shade")
    out = [f"{k} {c[k][0]} warps {c[k][1]} lanes (use "
           f"{c[k][1] / (32 * c[k][0]) if c[k][0] else float('nan'):.4f})"
           for k in stages]
    out += [f"{k} {v[1]}" for k, v in c.items()
            if k not in stages and v[1]]
    return ", ".join(out)


def phase_image_main(dev):
    """The disk image's main path: the headline frame through nt_setup ->
    render_disk_image in f64 and f32, held against the plain version; then
    the same frames through the counted instance (count_disk_image), whose
    images must be bitwise the main path's, for the kernel's counters."""
    from sim5_tpu_torch.render import kernel_image, render_disk_image
    from sim5_tpu_torch.render.image import render_disk_image_reference
    npix, n = N_IMAGE, N_IMAGE * N_IMAGE
    kernel_image.LAUNCHES.update(dict.fromkeys(kernel_image.LAUNCHES, 0))
    t0 = time.perf_counter()
    kern, counters = {}, {}
    for dt in (torch.float64, torch.float32):
        kern[dt] = render_disk_image(nt_disk(dt, dev), NT["incl"], npix, npix)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernel_image.LAUNCHES)
    forward = {*kernel_image.PROLOGUES.values(),
               *kernel_image.VARIANTS.values()}
    want = {k: int(k in forward) for k in counts}
    check(counts == want, f"the main path launched {counts}, not each "
          f"instance and its prologue once")
    for dt in (torch.float64, torch.float32):
        cf, cg = kernel_image.count_disk_image(nt_disk(dt, dev), NT["incl"],
                                               npix, npix)
        counters[dt] = kernel_image.image_counters()
        check(torch.equal(bits(cf), bits(kern[dt][0]))
              and torch.equal(bits(cg), bits(kern[dt][1])),
              f"{kernel_image.COUNTED[dt]}: the images are not bitwise the "
              f"main path's")
    plain = {dt: render_disk_image_reference(nt_disk(dt, dev), NT["incl"],
                                             npix, npix)
             for dt in (torch.float64, torch.float32)}
    torch.cuda.synchronize()
    for dt in kern:
        check_image(f"kernel {dt}", *kern[dt], npix)
        check_image(f"plain {dt}", *plain[dt], npix)
        check(kern[dt][0].dtype == dt, f"kernel image is {kern[dt][0].dtype}")
        check_image_counters(kernel_image.COUNTED[dt], counters[dt], n,
                             kern[dt][1])
    f64p, g64p = plain[torch.float64]
    err_f, mis_f, _ = image_err(kern[torch.float64][0], f64p)
    err_g, mis_g, _ = image_err(kern[torch.float64][1], g64p)
    check(err_f <= 1e-9 and err_g <= 1e-9, f"f64 kernel vs plain: image_f "
          f"{err_f:.3e}, image_g {err_g:.3e} of peak > 1e-9")
    check(mis_f <= 1e-5 * n, f"f64 kernel vs plain: footprint differs on "
          f"{mis_f} pixels")
    fast_k, mis_k, _ = image_err(kern[torch.float32][0], f64p)
    fast_p, mis_p, _ = image_err(plain[torch.float32][0], f64p)
    for tag, err, mis in (("f32 kernel", fast_k, mis_k),
                          ("f32 plain", fast_p, mis_p)):
        check(err <= 4e-6, f"{tag} vs f64 plain: {err:.3e} of peak > 4e-6")
        check(mis <= 1e-5 * n, f"{tag} vs f64 plain: footprint differs on "
              f"{mis} pixels > 1e-5 of {n}")
    # each kernel against its own plain version (the kernels line)
    errs = {dt: image_err(kern[dt][0], plain[dt][0])
            for dt in (torch.float64, torch.float32)}
    hit = float((f64p > 0).double().mean())
    print(f"phase 11 disk image main path ({npix}^2, a={NT['a']}, incl 80, "
          f"M={NT['M']}, mdot={NT['mdot']}, alpha={NT['alpha']}; "
          f"LAUNCHES={counts}, both frames {wall:.3f} s host clock incl. "
          f"nt_setup): f64 kernel vs f64 plain image_f {err_f:.3e} image_g "
          f"{err_g:.3e} of peak, footprint mismatch {mis_f} (gates 1e-9, "
          f"{1e-5 * n:.2f}) | fast_path_err_vs_f64={fast_k:.3e} (f32 kernel, "
          f"footprint mismatch {mis_k}) | f32 plain vs f64 plain {fast_p:.3e} "
          f"(mismatch {mis_p}) (gates 4e-6, {1e-5 * n:.2f}) | f32 kernel vs "
          f"f32 plain {errs[torch.float32][0]:.3e} of peak (mismatch "
          f"{errs[torch.float32][1]}) | hit share {hit:.4f} peak "
          f"{float(f64p.max()):.6e} flux {float(f64p.sum()):.6e} | counted "
          f"instances bitwise the main path's images | counters "
          + " | ".join(f"{kernel_image.COUNTED[dt]}: {counters_text(c)}"
                       for dt, c in counters.items()), flush=True)
    return counts, {dt: e[2] for dt, e in errs.items()}, fast_k, counters


def image_bound(dtype, counters, lengths, npix):
    """(bound_ms, bound_by) of one npix^2 frame whose counters are
    `counters`: the operations of its pixel classes (image_ops) over the
    peak rate of the type, or the bytes (two images written, six scalars
    read) over the memory rate."""
    item = torch.tensor([], dtype=dtype).element_size()
    t_ops = image_ops(dtype, counters, lengths) / PEAK[dtype]
    t_bytes = (2 * npix * npix + 6) * item / H100_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def event_runs(fn, reps):
    """ms a call of fn(), sorted, over IMAGE_RUNS CUDA-event pairs around
    `reps` calls each, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(IMAGE_RUNS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    return sorted(out)


def spread(ms, scale=1.0):
    return (f"{ms[0] * scale:.4f} / {ms[len(ms) // 2] * scale:.4f} / "
            f"{ms[-1] * scale:.4f}")


def host_runs(fn):
    """Seconds a call of fn() takes on the host clock, synchronised,
    sorted over SWEEP_RUNS calls after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(SWEEP_RUNS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return sorted(out)


def phase_image_timing(dev, name, errs, counters, lengths):
    """Each instance timed by CUDA events around runs of IMAGE_REPS
    launches: one headline frame a launch, and N_SWEEP frames of the spin
    sweep in one launch; the entry point's time a frame; the plain version
    once; the bound from the main path's counters.  Gates: every frame of
    an N_SWEEP-frame launch is bitwise the single-frame launch of its spin,
    in both instances; the f64 kernel on a batch of three spins at 128^2
    is within 1e-9 of the plain version's peak.  Then the f32 spin sweep
    through nt_setup(spins) -> render_disk_image in one launch, and the
    loop of one call a frame, on the host clock."""
    from sim5_tpu_torch import _build
    from sim5_tpu_torch.render import kernel_image, render_disk_image
    from sim5_tpu_torch.render.image import render_disk_image_reference
    npix, rows, parts = N_IMAGE, {}, []
    spins = sweep_spins()
    for dt in (torch.float64, torch.float32):
        name_k = kernel_image.VARIANTS[dt]
        disk = nt_disk(dt, dev)
        frames = kernel_image.frame_scalars(disk, NT["incl"]).reshape(1, 6)
        f = torch.empty((1, npix, npix), dtype=dt, device=dev)
        g = torch.empty_like(f)
        work = torch.empty((1, kernel_image.FRAME_WORDS), dtype=dt,
                           device=dev)
        cnt = kernel_image.new_counters(dev)
        one = event_runs(lambda: kernel_image._launch(frames, f, g, None,
                                                      work), IMAGE_REPS)
        counted = event_runs(lambda: kernel_image._launch(frames, f, g, cnt,
                                                          work), IMAGE_REPS)
        entry = event_runs(lambda: render_disk_image(disk, NT["incl"], npix,
                                                     npix), IMAGE_REPS)
        # the sweep's frames in one launch, each against its single frame
        batch = nt_disks(dt, dev, spins)
        bf, bg = render_disk_image(batch, NT["incl"], npix, npix)
        check_image(f"{name_k} {N_SWEEP}-frame launch", bf, bg, npix,
                    (N_SWEEP,))
        for k, a in enumerate(spins):
            sf, sg = render_disk_image(nt_disk(dt, dev, a=a), NT["incl"],
                                       npix, npix)
            check(torch.equal(bits(bf[k]), bits(sf))
                  and torch.equal(bits(bg[k]), bits(sg)),
                  f"{name_k}: frame {k} (a = {a}) of the {N_SWEEP}-frame "
                  f"launch is not bitwise its single-frame launch")
        framesN = kernel_image.frame_scalars(batch, NT["incl"])
        workN = torch.empty((N_SWEEP, kernel_image.FRAME_WORDS), dtype=dt,
                            device=dev)
        many = event_runs(lambda: kernel_image._launch(framesN, bf, bg, None,
                                                       workN), 2)
        plain_ms, _ = timed(render_disk_image_reference, (disk, NT["incl"],
                                                          npix, npix), {})
        bound_ms, bound_by = image_bound(dt, counters[dt], lengths, npix)
        rows[name_k] = dict(ms=one[0], plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, max_abs_err=errs[dt],
                            ms_batch=many[0] / N_SWEEP)
        ops = image_ops(dt, counters[dt], lengths)
        # --fmad=false: each counted operation is one instruction, issued
        # at half the FLOP peak (which counts an FMA as two)
        issue_ms = 2 * ops / PEAK[dt] * 1e3
        parts.append(
            f"{name_k}: one frame a launch {spread(one)} ms (min / median / "
            f"max of {IMAGE_RUNS} runs of {IMAGE_REPS} launches; "
            f"{npix * npix / (one[0] * 1e-3):.4e} rays/s); {N_SWEEP} frames "
            f"a launch {spread(many, 1 / N_SWEEP)} ms a frame; "
            f"{kernel_image.COUNTED[dt]} one frame a launch {spread(counted)}"
            f" ms ({counted[0] / one[0] - 1:+.2%}); the entry point "
            f"render_disk_image, one frame a call, {spread(entry)} ms; "
            f"bound {bound_ms:.4f} ms ({bound_by}, "
            f"{ops / (npix * npix):.1f} operations a pixel over the frame's "
            f"classes; {bound_ms / one[0]:.3f} of the one-frame launch, "
            f"{bound_ms / rows[name_k]['ms_batch']:.3f} of a frame in the "
            f"{N_SWEEP}-frame launch); at the instruction issue rate "
            f"{issue_ms:.4f} ms ({issue_ms / one[0]:.3f}, "
            f"{issue_ms / rows[name_k]['ms_batch']:.3f}); plain "
            f"{plain_ms:.3f} ms; every frame of the {N_SWEEP}-frame launch "
            f"bitwise its single-frame launch")
    # the f64 kernel on a batch of spins against the plain version's batch
    small = nt_disks(torch.float64, dev, list(BATCH_SPINS))
    kf, _ = render_disk_image(small, NT["incl"], N_BATCH, N_BATCH)
    pf, _ = render_disk_image_reference(small, NT["incl"], N_BATCH, N_BATCH)
    batch_errs = [image_err(kf[k], pf[k]) for k in range(len(BATCH_SPINS))]
    for a, (err, mis, _) in zip(BATCH_SPINS, batch_errs):
        check(err <= 1e-9, f"f64 batch, a = {a}: kernel vs plain {err:.3e} "
              f"of the peak > 1e-9")
        check(mis <= 1e-5 * N_BATCH * N_BATCH, f"f64 batch, a = {a}: "
              f"footprint differs on {mis} pixels")
    # the f32 spin sweep through the entry points: one launch, and the loop
    # of one call a frame
    lib = kernel_image._lib()
    before = kernel_image.LAUNCHES["nt_image<float>"]

    def sweep_once():
        return render_disk_image(nt_disks(torch.float32, dev, spins),
                                 NT["incl"], npix, npix)

    def sweep_loop():
        for a in spins:
            out = render_disk_image(nt_disk(torch.float32, dev, a=a),
                                    NT["incl"], npix, npix)
        return out

    one_launch = host_runs(sweep_once)
    mid = kernel_image.LAUNCHES["nt_image<float>"]
    loop = host_runs(sweep_loop)
    launches_once = (mid - before) // (SWEEP_RUNS + 1)
    launches_loop = (kernel_image.LAUNCHES["nt_image<float>"] - mid) // (
        SWEEP_RUNS + 1)
    libs = sorted(_build.BUILD_DIR.glob(f"libdisk_image_{'?' * 16}.so"))
    check(launches_once == 1 and launches_loop == N_SWEEP,
          f"the sweeps launched {launches_once} and {launches_loop} times")
    check(kernel_image._lib() is lib and len(libs) == 1,
          f"the sweep rebuilt the library: {libs}")
    check_image("sweep, one launch", *sweep_once(), npix, (N_SWEEP,))
    device_ms = rows["nt_image<float>"]["ms_batch"]
    print(f"phase 12 disk image timing ({npix}^2; {name}): "
          + " | ".join(parts) + f" | device_ms_per_frame={device_ms:.4f} "
          f"(f32, a frame of the {N_SWEEP}-frame launch) | f64 kernel vs "
          f"plain on a batch of spins {BATCH_SPINS} at {N_BATCH}^2: "
          + ", ".join(f"{e:.3e} (mismatch {m})" for e, m, _ in batch_errs)
          + f" of each frame's peak (gate 1e-9) | spin sweep of {N_SWEEP} "
          f"f32 frames (a = 0.998 - 2e-4 k), host clock, min / median / max "
          f"of {SWEEP_RUNS}: nt_setup(spins) -> render_disk_image in one "
          f"launch {spread(one_launch)} s, {N_SWEEP / one_launch[0]:.2f} "
          f"frames/s ({N_SWEEP * npix * npix / one_launch[0]:.4e} rays/s); "
          f"one call a frame {spread(loop)} s, {N_SWEEP / loop[0]:.2f} "
          f"frames/s; one library ({libs[0].name}) for every spin",
          flush=True)
    return rows


# --- phases 13-15: the analytic azimuth and travel time, the orbiting
# source through the volume path, and example 07's hot-spot light curve

EPS64 = float(np.finfo(np.float64).eps)


def phi_bound(g, phi):
    """The bound on phi between two evaluations of the same f64 algebra
    whose sin/cos round differently by an ulp (the card's and the CPU's):
    near a poloidal turning point x -> b = sqrt(m2p) the theta term's
    integrand goes as 1 / ((1 - b^2) sqrt(a^2 + b^2) sqrt(2b (b - x))),
    so an ulp of cn moves phi by about sqrt(eps) |l/a| / ((1 - m2p)
    sqrt(m2m + m2p)) (tests/test_torch_azimuth.py measures 1-2 x that
    between the JAX package's jitted and op-by-op programs)."""
    S = (g.l / g.a).abs() / ((1.0 - g.m2p).abs()
                              * (g.m2m + g.m2p).abs().sqrt())
    return 8.0 * math.sqrt(EPS64) * S + 1e-12 * (1.0 + phi.abs())


def time_bound(g, t, t_far=0.0):
    """The same for a travel time: its poloidal part a integral_T_m2 has
    the same turning point, sqrt(eps) a m2p / sqrt(m2m + m2p); its radial
    part from a far radius t_far in is a sum of Byrd & Friedman terms of
    size ~t_far that cancel down to the result, and loses up to 1.1e-11
    t_far (the jitted JAX program against the port from R_FAR = 1e4,
    tests/test_torch_slow_parity.py): 1e-10 t_far."""
    return (8.0 * math.sqrt(EPS64) * g.a * g.m2p
            / (g.m2m + g.m2p).abs().sqrt() + 1e-12 * (1.0 + t.abs())
            + 1e-10 * t_far)


def far_bound(g, r):
    """The spread of a crossing's radius (and of a delay from it) far
    out: there P_inf - P ~ 1/r, so dr ~ r^2 dP, and P = (2 order + 1)
    Tpp / 2 +- Tip carries the roundings of Tpp (K's AGM) and Tip (an RF
    duplication chain), a few dozen ulps of Tpp + |Tip|: 32 here.  An
    order-1 crossing of example 07's map lies at r ~ 1e5, where one ulp of
    the inclination moves the plain chain's r by 2.3e-11 relative; the
    kernel and the plain chain on the card differ by up to 8.5e-11
    relative among those crossings."""
    return 32.0 * EPS64 * r * r * (g.Tpp + g.Tip.abs())


def golden_rows(fname, tag):
    """The rows of one tag of a golden file in tests/golden."""
    path = pathlib.Path(__file__).resolve().parent / "tests" / "golden"
    return np.asarray([[float(v) for v in line.split()[1:]] for line in
                       (path / fname).read_text().splitlines()
                       if line.split()[:1] == [tag]])


def gpos_rows():
    """(a, incl, alpha, beta, P, phi) of geod.txt's position samples of the
    geodesics the reference initialized."""
    path = pathlib.Path(__file__).resolve().parent / "tests" / "golden"
    rows, cur = [], None
    for line in (path / "geod.txt").read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        vals = [float(v) for v in parts[1:]]
        if parts[0] == "ginit":
            cur = vals if vals[4] == 1 else None
        elif parts[0] == "gpos" and cur is not None:
            rows.append(cur[:4] + [vals[0], vals[3]])
    return np.asarray(rows)


def worst(err, bound, sel):
    """(max err / bound, max err, the bound there) over `sel`."""
    ratio = torch.where(sel, err / bound, 0.0)
    i = int(ratio.flatten().argmax())
    return (float(ratio.flatten()[i]), float(err[sel].max()),
            float(bound.flatten()[i]))


def analytic_f64(device):
    """The seed's azimuth (VOL_SPOT at N_ANALYTIC^2, f64) and the crossing
    map (order 0, N_ANALYTIC^2) on `device`: on the card their kernels
    (kernel_analytic.volume_seed_rays, equatorial_crossing_map), on the
    CPU their plain chains; and the two image grids' geodesics."""
    from sim5_tpu_torch import geodesic as gd
    from sim5_tpu_torch.render import kernel_analytic, lightcurve, image_grid
    c = VOL_SPOT
    x0, _, ok = kernel_analytic.volume_seed_rays(
        c["a"], c["incl"], 0.0, N_ANALYTIC, c["rmax"], c["r_start"], False,
        torch.float64, device)
    phi = x0[..., 3]
    g = gd.geodesic_init_inf(c["incl"], c["a"], *image_grid(
        N_ANALYTIC, N_ANALYTIC, c["rmax"], device=device))
    m = lightcurve.equatorial_crossing_map(c["a"], c["incl"], N_ANALYTIC,
                                           2.5 * SPOT["r_spot"], 0,
                                           device=device)
    alpha, beta = image_grid(N_ANALYTIC, N_ANALYTIC, 2.5 * SPOT["r_spot"],
                             device=device)
    gm = gd.geodesic_init_inf(c["incl"], c["a"], alpha, beta)
    if device != "cpu":
        torch.cuda.synchronize()
    return g, ok, phi, m, gm


def _dumps(obj):
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def start_cpu_references():
    """Starts the host-CPU references of phases 13 and 19 in two worker
    processes (spawned: no CUDA), beside the phases; returns the pool.
    They need no card and take tens of seconds of eager f64 on the CPU."""
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"))
    BACKGROUND["cpu analytic"] = pool.submit(cpu_analytic)
    BACKGROUND["cpu thickdisk"] = pool.submit(cpu_thickdisk)
    return pool


def cpu_result(key, fn):
    """fn()'s result, a host-CPU reference: from the worker that
    `start_cpu_references` started, else computed here."""
    fut = BACKGROUND.pop(key, None)
    return torch.load(io.BytesIO(fut.result() if fut is not None else fn()),
                      weights_only=False)


def cpu_analytic():
    """analytic_f64 on the CPU and its seconds (serialized)."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = analytic_f64("cpu")
    return _dumps((out, time.perf_counter() - t0))


def phase_analytic(dev):
    """The analytic azimuth and travel time on the card: against the C
    goldens, and against the same torch code on the CPU in f64."""
    from sim5_tpu_torch import geodesic as gd
    from sim5_tpu_torch.render import lightcurve
    d = gpos_rows()
    t = [torch.tensor(d[:, i], device=dev) for i in range(6)]
    g = gd.geodesic_init_inf(t[1], t[0], t[2], t[3])
    r = gd.geodesic_position_rad(g, t[4])
    m = gd.geodesic_position_pol(g, t[4])
    phi = gd.geodesic_position_azm(g, r, m, t[4])
    ok = (torch.isfinite(t[5]) & torch.isfinite(phi) & torch.isfinite(r)
          & torch.isfinite(m))
    close = ((phi - t[5]).abs() <= 1e-6 + 1e-4 * t[5].abs())[ok]
    frac = float(close.double().mean())
    check(int(ok.sum()) > 100 and frac > 0.97,
          f"azimuth vs C golden: {frac:.4f} of {int(ok.sum())} within "
          f"rtol 1e-4 atol 1e-6 (gate > 0.97)")
    d = golden_rows("timedelay.txt", "td")
    t = [torch.tensor(d[:, i], device=dev) for i in range(10)]
    g = gd.geodesic_init_inf(t[1], t[0], t[2], t[3])
    dt = gd.geodesic_timedelay(g, t[4], t[5], t[6], t[7], t[8],
                               torch.zeros_like(t[8]))
    fin = torch.isfinite(dt) == torch.isfinite(t[9])
    both = torch.isfinite(dt) & torch.isfinite(t[9])
    td_ok = ((dt - t[9]).abs() <= 1e-7 + 1e-5 * t[9].abs())[both]
    td_frac = float(td_ok.double().mean())
    check(float(fin.double().mean()) > 0.95 and td_frac > 0.95,
          f"time delay vs C golden: finiteness agrees on "
          f"{float(fin.double().mean()):.4f}, {td_frac:.4f} within rtol "
          f"1e-5 atol 1e-7 (gates > 0.95)")
    # the kernels on the card against the plain chains on the CPU, f64
    from sim5_tpu_torch.render import kernel_analytic
    reset_analytic()
    t0 = time.perf_counter()
    gk, okk, phik, mk, gmk = analytic_f64(dev)
    card_s = time.perf_counter() - t0
    launches = analytic_launches()
    seed_v = kernel_analytic.SEEDS[torch.float64, True]
    check(launches[kernel_analytic.CROSSING] == 1 and launches[seed_v] == 1,
          f"the card's seed and crossing map launched {launched(launches)}")
    (gc, okc, phic, mc, gmc), cpu_s = cpu_result("cpu analytic",
                                                 cpu_analytic)
    okc = okc & torch.isfinite(phic)
    check(torch.equal(okk.cpu() & torch.isfinite(phik.cpu()), okc),
          "seed: valid pixels differ between the card and the CPU")
    seed_w = worst((phik.cpu() - phic).abs(), phi_bound(gc, phic), okc)
    hit = mc["hit"]
    check(torch.equal(mk["hit"].cpu(), hit),
          "crossing map: hit pixels differ between the card and the CPU")
    rel = {k: float(((mk[k].cpu() - mc[k]).abs() / mc[k].abs())[hit].max())
           for k in ("r", "g")}
    map_phi = worst((mk["phi"].cpu() - mc["phi"]).abs(),
                    phi_bound(gmc, mc["phi"]), hit)
    tb = time_bound(gmc, mc["delay"], lightcurve.R_FAR)
    tb = tb + tb[hit][int(mc["delay"][hit].argmin())]   # the anchor pixel
    map_dt = worst((mk["delay"].cpu() - mc["delay"]).abs(), tb, hit)
    for k, v in rel.items():
        check(v <= 1e-12, f"crossing map {k}: card vs CPU {v:.3e} > 1e-12")
    for tag, w in (("seed phi", seed_w), ("map phi", map_phi),
                   ("map delay", map_dt)):
        check(w[0] <= 1.0, f"{tag}: card vs CPU {w[1]:.3e} exceeds its "
              f"bound ({w[0]:.3f} of it)")
    print(f"phase 13 analytic azimuth and delay: vs C goldens on the card: "
          f"phi {frac:.4f} of {int(ok.sum())} samples within rtol 1e-4 "
          f"atol 1e-6 (gate > 0.97), time delay {td_frac:.4f} within rtol "
          f"1e-5 atol 1e-7 (gate > 0.95) | the kernels on the card "
          f"(LAUNCHES={launched(launches)}) vs the plain chains on the CPU, "
          f"f64, "
          f"{N_ANALYTIC}^2 (card {card_s:.2f} s, CPU {cpu_s:.2f} s in a "
          f"worker process beside the phases): "
          f"crossing map r {rel['r']:.3e}, g {rel['g']:.3e} relative (gate "
          f"1e-12); phi and delay against their per-pixel bounds "
          f"(8 sqrt(eps) times the turning-point factor; + 1e-10 R_FAR for "
          f"the delay's radial part): seed phi max "
          f"{seed_w[1]:.3e} rad ({seed_w[0]:.3f} of its bound, bound there "
          f"{seed_w[2]:.3e}), map phi max {map_phi[1]:.3e} rad "
          f"({map_phi[0]:.3f}, {map_phi[2]:.3e}), map delay max "
          f"{map_dt[1]:.3e} ({map_dt[0]:.3f}, {map_dt[2]:.3e})", flush=True)


def spot(alpha0=1.0):
    """Example 07's spot as a 3-D source orbiting at OmegaK(7, 0.5) (alpha0
    = 1), or its absorption alpha0 * j (None for alpha0 = 0)."""
    from sim5_tpu_torch.core import OmegaK
    from sim5_tpu_torch.march.emission import GaussianSource
    if alpha0 == 0.0:
        return None
    om = float(OmegaK(torch.tensor(SPOT["r_spot"], dtype=torch.float64),
                      SPOT["a"]))
    w = 1.0 / SPOT["size"]
    return GaussianSource(amp=alpha0, center=SPOT["r_spot"], inv_width=w,
                          inv_height=w, cylindrical=True, omega=om,
                          inv_arc=w)


def seed_stages(dev, cfg, npix):
    """Seconds of the f64 seed at npix^2 as the entry point runs it on the
    card, warm, on the synchronised host clock: the seed kernel's rays
    (one launch, with its allocations) and raytrace_prepare."""
    from sim5_tpu_torch.march import raytrace_prepare
    from sim5_tpu_torch.render import kernel_analytic
    (x0, k, _), rays_s = synced_seconds(
        lambda: kernel_analytic.volume_seed_rays(
            cfg["a"], cfg["incl"], 0.0, npix, cfg["rmax"], cfg["r_start"],
            cfg["axisymmetric"], torch.float64, dev))
    _, prep_s = synced_seconds(lambda: raytrace_prepare(
        cfg["a"], x0, k, precision=cfg["precision"]))
    return [rays_s, prep_s]


def phase_orbit_volume(dev, name):
    """The volume path with its default azimuth stage and an orbiting
    source, through the march kernel: the 512^2 main path thin and thick,
    the seed's stages, the thick kernel against the f64 loop engine
    (N_VOL_LOOP^2; phase 8 holds the torus's thin one), the light curve's
    periodicity, and the march timed on the 512^2 seed and held against
    its plain version there (phase 9's gates; the plain march of both
    variants in one call, `plain_together`).  Returns the launches and
    the kernels line's row of each variant."""
    from sim5_tpu_torch.core import OmegaK
    from sim5_tpu_torch.march import kernel_march
    from sim5_tpu_torch.render import volume_lightcurve
    cfg = VOL_SPOT
    images, launches, march, parts, gate = volume_main(dev, cfg, spot)
    for v, n in launches.items():
        check(n >= 1, f"orbiting source: {v} launched {n} times")
    stages = seed_stages(dev, cfg, N_VOL_PIX)   # warm: the images ran it
    loop_text = volume_loop(dev, N_VOL_LOOP, 1.0, cfg, spot)
    # the source is periodic in t and the spacetime stationary: one period
    # later the light curve repeats
    period = 2.0 * math.pi / float(OmegaK(torch.tensor(
        SPOT["r_spot"], dtype=torch.float64), SPOT["a"]))
    reset_analytic()
    flux, lc_s = synced_seconds(lambda: volume_lightcurve(
        cfg["a"], cfg["incl"], spot(), [0.0, period], engine="kernel",
        device=dev, **volume_kw(cfg, N_VOL_PIX)))
    lc_seeds = analytic_launches()[seed_name(cfg)]
    check(lc_seeds == 2, f"the light curve's two samples launched "
          f"{seed_name(cfg)} {lc_seeds} times")
    lc_rel = abs(flux[1] - flux[0]) / abs(flux[0])
    check(flux[0] > 0.0 and lc_rel <= 1e-3, f"orbiting source: flux at t0 "
          f"= 0 and one period later differ by {lc_rel:.3e} > 1e-3")
    # the march timed on the 512^2 seed and held against its plain
    # version on the same inputs, as phase 9
    st0, ok = volume_seed_f32(N_VOL_PIX, dev, cfg)
    tensors, scalars = kernel_march._pack(
        st0, 1.2 * cfg["r_start"], cfg["max_steps"], 1e-2, ok)
    n = N_VOL_PIX * N_VOL_PIX
    ms_p, plains = timed(plain_together, ([
        (tensors, spot(), spot(alpha0)) for alpha0 in ALPHA0], scalars), {})
    rows, timed_parts = {}, []
    for alpha0, out_p in zip(ALPHA0, plains):
        rt = 1 if alpha0 == 0.0 else 2
        tag = f"orbiting {N_VOL_PIX}^2 alpha0={alpha0}"
        kw = dict(scalars, emissivity=spot(), absorption=spot(alpha0))
        timing, same = march_timing(tensors, kw)
        eq, rel, dI, peak_p = compare_transfer(timing[1], out_p, st0)
        check(peak_p > 0.0, f"{tag}: plain peak I is {peak_p}")
        check(eq > 0.9, f"{tag}: equal steps {eq:.4f}")
        check(dI <= 1e-3 * peak_p, f"{tag}: |dI| {dI:.3e} > 1e-3 of peak "
              f"{peak_p:.4e}")

        def max_dI(outs, plain):
            return compare_transfer(outs, plain, st0)[2]

        text, rows[rt] = timing_report(tag, n, rt, timing, same, out_p,
                                       ms_p, max_dI)
        timed_parts.append(
            f"alpha0={alpha0}: {text} | kernel vs plain: equal steps "
            f"{eq:.4f} rel dr {rel:.3e} |dI| {dI:.3e} ({dI / peak_p:.3e} of "
            f"peak {peak_p:.4e})")
    # the seed's share of one image, from this phase's own seed and march
    # times
    image_s = sum(stages) + rows[1]["ms"] * 1e-3
    peak = float(images[0.0].max())
    print(f"phase 14 orbiting source through the volume path ({N_VOL_PIX}^2, "
          f"a={cfg['a']}, incl {math.degrees(cfg['incl']):.0f}, spot at r="
          f"{SPOT['r_spot']} of width, height and arc {SPOT['size']}, omega "
          f"{2 * math.pi / period:.6f}, r_start {cfg['r_start']}, "
          f"{cfg['max_steps']} steps, default axisymmetric=False; {name}): "
          + " | ".join(parts) + f" | {gate} | the seed (f64, host clock, "
          f"warm): the kernel's rays {stages[0]:.4f} s, raytrace_prepare "
          f"{stages[1]:.4f} s; the seed is {sum(stages) / image_s:.4f} of "
          f"seed + thin march ({image_s:.3f} s) | vs f64 loop "
          f"({N_VOL_LOOP}^2; gate "
          f"2e-2 of peak): {loop_text} | light curve t0 = 0 / one period: "
          f"{flux[0]:.9e} / {flux[1]:.9e}, relative {lc_rel:.3e} (gate "
          f"1e-3), {lc_s / 2:.4f} s a sample (host clock, one seed launch "
          f"each) | march timed on the {N_VOL_PIX}^2 seed (gates: equal "
          f"steps > 0.9, |dI| <= 1e-3 of peak; plain: both variants in one "
          f"call, {ms_p:.3f} ms): " + " | ".join(timed_parts)
          + f" | peak {peak:.4e}", flush=True)
    return launches, rows


def phase_hotspot(dev):
    """Example 07 at its full size: the crossing maps at 192^2 (orders 0
    and 1), the light curve over two orbital periods in 96 samples given
    the maps, the entry point, and the crossing map at 512^2."""
    from sim5_tpu_torch.core import OmegaK
    from sim5_tpu_torch.render import (equatorial_crossing_map,
                                       hotspot_lightcurve, lightcurve)
    a, incl, rs, size = (SPOT[k] for k in ("a", "incl", "r_spot", "size"))
    Om = OmegaK(torch.tensor(rs, dtype=torch.float64, device=dev), a)
    period = 2.0 * math.pi / float(Om)
    t_obs = np.arange(HOTSPOT_T) / HOTSPOT_T * 2 * period
    maps, map_s = [], []
    reset_analytic()
    for order in (0, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps.append(equatorial_crossing_map(a, incl, N_HOTSPOT, 2.5 * rs,
                                            order, device=dev))
        torch.cuda.synchronize()
        map_s.append(time.perf_counter() - t0)
    from sim5_tpu_torch.render import kernel_analytic
    v = kernel_analytic.CROSSING
    map_launches = analytic_launches()[v]
    check(map_launches == 2, f"the two maps launched {v} {map_launches} "
          f"times")
    t = torch.as_tensor(t_obs, device=dev)
    t0 = time.perf_counter()
    lc = sum(lightcurve.spot_flux(m, Om, rs, size, t) for m in maps)
    torch.cuda.synchronize()
    lc_s = time.perf_counter() - t0
    # the main path: the entry point, both orders in one launch
    reset_analytic()
    t0 = time.perf_counter()
    lc_entry = hotspot_lightcurve(a, incl, rs, size, t_obs, npix=N_HOTSPOT,
                                  n_orders=2, device=dev)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    entry_launches = analytic_launches()
    check(entry_launches[v] == 1, f"the entry point launched "
          f"{launched(entry_launches)}, not {v} once")
    check(torch.equal(lc, lc_entry), "the light curve composed from the "
          "maps is not bitwise the entry point's")
    check(bool(torch.isfinite(lc).all()) and bool((lc > 0).all()),
          "light curve not finite and positive")
    half = HOTSPOT_T // 2
    per_rel = float(((lc[half:] - lc[:half]).abs() / lc[:half]).max())
    check(per_rel <= 1e-9, f"light curve: sample k vs k + {half} (one "
          f"period) {per_rel:.3e} > 1e-9")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big = equatorial_crossing_map(a, incl, N_MAP, 2.5 * rs, 0, device=dev)
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    hits = []
    for tag, m in ((f"{N_HOTSPOT}^2 order 0", maps[0]),
                   (f"{N_HOTSPOT}^2 order 1", maps[1]),
                   (f"{N_MAP}^2 order 0", big)):
        d = m["delay"][m["hit"]]
        check(d.numel() > 0 and float(d.min()) == 0.0 and bool(
            torch.isfinite(d).all()), f"{tag}: delays over hits not finite "
              f"with minimum exactly 0")
        hits.append(f"{tag} {float(m['hit'].double().mean()):.4f} (delays "
                    f"0 to {float(d.max()):.4f})")
    lcn = lc.cpu().numpy()
    print(f"phase 15 hot-spot light curve (example 07: a={a}, incl "
          f"{math.degrees(incl):.0f}, r_spot {rs}, size {size}, "
          f"{N_HOTSPOT}^2, orders 0 and 1, {HOTSPOT_T} samples over two "
          f"periods of {period:.4f}): crossing maps {map_s[0]:.4f} / "
          f"{map_s[1]:.4f} s (one {v} launch each), the light curve given "
          f"the maps {lc_s * 1e3:.3f} ms, the entry point {entry_s:.4f} s "
          f"(host clock, synchronised; LAUNCHES={launched(entry_launches)}) "
          f"| crossing map at {N_MAP}^2 {big_s:.4f} s | hit fractions: "
          + ", ".join(hits) + f" | flux min {lcn.min():.6e} max "
          f"{lcn.max():.6e} (modulation {lcn.max() / lcn.min():.3f}x), one "
          f"period apart within {per_rel:.3e} (gate 1e-9)", flush=True)
    return dict(map_s=map_s, lc_s=lc_s, entry_s=entry_s, big_s=big_s,
                launches=entry_launches)


# --- phase 28: the analytic engine's kernels (csrc/crossing_map.cu,
# csrc/volume_seed.cu) against their plain torch chains on the card

ANALYTIC_REPS = 2        # launches between two CUDA events (phase 28)
OPS_THREADS = 6          # host threads of the operation counter
# bytes of a listed pixel's entry in the work buffer (its geodesic's 27
# scalars and 3 ints and its position: csrc/crossing_map.cu's HitGeom,
# csrc/volume_seed.cu's SeedGeom<T>), written by the first pass and read
# by the second
HIT_ENTRY_BYTES = 29 * 8 + 12
SEED_ENTRY_BYTES = {torch.float64: 28 * 8 + 12, torch.float32: 28 * 4 + 12}
# the seeds phase 28 holds against their plain chain: example 07's spot
# with and without the azimuth in f64 and f32, and example 11's torus
# (axisymmetric, f64), each at N_VOL_PIX^2
SEED_CASES = (("spot", VOL_SPOT, torch.float64, False),
              ("spot", VOL_SPOT, torch.float64, True),
              ("spot", VOL_SPOT, torch.float32, False),
              ("spot", VOL_SPOT, torch.float32, True),
              ("torus", VOL, torch.float64, True))


def reset_analytic():
    """Every analytic kernel's launch count set to 0."""
    from sim5_tpu_torch.render import kernel_analytic
    kernel_analytic.LAUNCHES.update(dict.fromkeys(kernel_analytic.LAUNCHES,
                                                  0))


def analytic_launches():
    """The analytic kernels' launch counts since the last reset: each
    pass's, and each kernel's (kernel_analytic.PASSES) where each of its
    passes launched as many times, else -1."""
    from sim5_tpu_torch.render import kernel_analytic
    counts = dict(kernel_analytic.LAUNCHES)
    for kernel, passes in kernel_analytic.PASSES.items():
        n = {counts[p] for p in passes}
        counts[kernel] = n.pop() if len(n) == 1 else -1
    return counts


def seed_name(cfg, dtype=torch.float64):
    """The seed kernel's instance a volume configuration launches."""
    from sim5_tpu_torch.render import kernel_analytic
    return kernel_analytic.SEEDS[dtype, not cfg["axisymmetric"]]


def seed_bounds(g, x0, k):
    """Per-pixel bounds on the f64 seed's r0, m0 and k between two
    evaluations of its algebra: 1e-12 of each field's scale (max(|v|,
    1e-3 of the field's peak): m0 and k's components pass through 0), and
    where a field passes through 0 its own spread: m0 = -sign sqrt(m2p)
    cn(dT / mK) moves by sqrt(m2p) dT / mK, dT rounding by 8 ulps of Tpp
    + |Tip| + Rpc; k^r = sqrt(R) / S and k^theta = sqrt(M) / S, with R and
    M rounding by 8 ulps of their terms, move by min(dR / (2 |k| S^2),
    sqrt(dR) / S) near a turning point (on the spot's 512^2 seed one ulp
    of the inclination moves the plain chain's k^theta by 1.6e-9 of its
    scale there, on a CPU).  Returns (r0, m0, k) bounds."""
    r, m = x0[..., 1].double(), x0[..., 2].double()
    k = k.double()

    def scale(v):
        return 1e-12 * v.abs().clamp(min=1e-3 * float(v.abs().max()))

    e8 = 8.0 * EPS64
    a, l, q = g.a, g.l, g.q
    a2, r2, m2 = a * a, r * r, m * m
    S = r2 + a2 * m2
    D = r2 - 2.0 * r + a2
    A = r2 + a2 - a * l
    dR = e8 * (A * A + D.abs() * ((l - a) ** 2 + q.abs()))
    dM = e8 * (q.abs() + l * l * m2 / (1.0 - m2) + a2 * m2)

    def root(dX, kc):
        return torch.minimum(dX / (2.0 * kc.abs() * S * S), dX.sqrt() / S)

    b_m = scale(m) + e8 * g.m2p.sqrt() * (g.Tpp + g.Tip.abs() + g.Rpc) / g.mK
    b_k = torch.stack([scale(k[..., 0]), scale(k[..., 1]) + root(dR, k[..., 1]),
                       scale(k[..., 2]) + root(dM, k[..., 2]),
                       scale(k[..., 3])], -1)
    return scale(r), b_m, b_k


def synced_seconds(fn):
    """(fn(), its seconds on the synchronised host clock)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def start_op_counts():
    """Phase 28's launches' operation counts (kernel_analytic.
    operation_counts: the kernels' pixels on a counting scalar on the
    host's cores) at Carlson's rule, the kernels' depth, and for the crossing
    map and the f64 seed with the azimuth also at the fixed depth of PR
    14's kernels, in a thread beside the card's work: a future of {key:
    counts}, key ("crossing", adaptive) or (case, dtype, axisymmetric,
    adaptive)."""
    def run():
        from sim5_tpu_torch.render import kernel_analytic as ka
        out = {}
        for adaptive in (True, False):
            out["crossing", adaptive] = ka.operation_counts(
                "crossing", SPOT["a"], SPOT["incl"], N_HOTSPOT,
                2.5 * SPOT["r_spot"], (0, 1), threads=OPS_THREADS,
                adaptive=adaptive)[0]
        for case, cfg, dt, axi in SEED_CASES:
            for adaptive in ((True, False) if (dt == torch.float64 and not axi
                                               and case == "spot")
                             else (True,)):
                out[case, dt, axi, adaptive] = ka.operation_counts(
                    "seed", cfg["a"], cfg["incl"], N_VOL_PIX, cfg["rmax"],
                    r_start=cfg["r_start"], dtype=dt, axisymmetric=axi,
                    threads=OPS_THREADS, adaptive=adaptive)[0]
        return out
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run)
    pool.shutdown(wait=False)
    return fut


def analytic_bound(ops, out_bytes):
    """(ms, "operations" or "bytes"): the counted operations of each
    precision over its peak rate (each addition, multiplication, division,
    square root and transcendental one operation), or the bytes written
    once and read once over HBM's rate, the larger."""
    t_ops = (sum(ops["f64"].values()) / H100_FP64
             + sum(ops["f32"].values()) / H100_FP32) * 1e3
    t_bytes = out_bytes / H100_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def issue_bound(ops, fns, lengths):
    """ms of the counted operations as issue slots of the FP64 (FP32)
    pipe: an addition or multiplication one instruction, a division,
    square root or transcendental the instructions of its SASS sequence
    that issue to that pipe (op_lengths' "pipe" counts: not its MUFU
    seed, integer, predicate or branch instructions; but those of an
    inlined slow path it branches over, which the pipe may not issue), at
    half the peak FLOP rate (an FMA counts two operations there); None
    without the lengths."""
    if not lengths:
        return None
    ms = 0.0
    for p, t, peak in (("f64", "d", H100_FP64), ("f32", "f", H100_FP32)):
        o, f = ops[p], fns[p]
        slots = (o["add"] + o["mul"]
                 + o["div"] * lengths[("div", t, "pipe")]
                 + o["sqrt"] * lengths[("sqrt", t, "pipe")]
                 + sum(n * lengths[(fn, t, "pipe")] for fn, n in f.items()))
        ms += slots / (peak / 2.0) * 1e3
    return ms


def ops_text(ops):
    return ", ".join(f"{p} " + "/".join(str(v) for v in ops[p].values())
                     for p in ("f64", "f32") if sum(ops[p].values()))


def tensors_of(out):
    """The tensors of a kernel's outputs (a dict or a tuple), in order."""
    return list(out.values()) if isinstance(out, dict) else list(out)


def counted_table(stages, chains):
    """The counted run's stages (warps, lane use, Mcycles and share of the
    counted cycles) and chains (calls, mean levels, lane use of the
    levels issued) as text."""
    total = sum(v["cycles"] for v in stages.values()) or 1
    st = "; ".join(
        f"{s} {v['warps']} warps, {v['lanes'] / (32 * v['warps']):.3f} lane "
        f"use, {v['cycles'] / 1e6:.2f} Mcycles ({v['cycles'] / total:.3f})"
        for s, v in stages.items() if v["warps"])
    ch = "; ".join(
        f"{c} {v['lane_calls']} lane calls, {v['levels'] / v['lane_calls']:.2f}"
        f" levels, {v['levels'] / max(v['levels_issued'], 1):.3f} of the "
        f"issued" for c, v in chains.items() if v["lane_calls"])
    return f"stages: {st} | chains: {ch}"


def analytic_counted(dev, outs):
    """Phase 28's counted runs (kernel_analytic.counted_run): the crossing
    map (192^2, orders 0-1) and the spot's f64 seed with the azimuth
    (512^2) through the counted instances of their two passes; each run's
    outputs bitwise the kernels' own (`outs`), its time (CUDA events, the
    counters' atomics included) and its counters.  Returns the text."""
    from sim5_tpu_torch.render import kernel_analytic as ka
    t0 = time.perf_counter()
    futs = BACKGROUND.pop("analytic_counted", None)
    if futs is None:     # the phase run alone: build them now
        for lib in ("crossing_map", "volume_seed"):
            ka._lib(f"{lib}_counted")
    else:
        for f in futs:
            f.result()
    wait_s = time.perf_counter() - t0
    a, incl, rmax = SPOT["a"], SPOT["incl"], 2.5 * SPOT["r_spot"]
    cfg = VOL_SPOT
    runs = {"crossing": lambda: ka.counted_run(
                "crossing", a, incl, N_HOTSPOT, rmax, (0, 1), device=dev),
            "seed": lambda: ka.counted_run(
                "seed", cfg["a"], cfg["incl"], N_VOL_PIX, cfg["rmax"],
                r_start=cfg["r_start"], device=dev)}
    parts = []
    for kind, fn in runs.items():
        out, stages, chains = fn()
        ms = event_runs(fn, 1)
        parts.append(f"{kind}: {ms[0]:.4f} ms counted | "
                     + counted_table(stages, chains))
        check(same_bits(tensors_of(out), tensors_of(outs[kind])),
              f"counted {kind}: the counted two passes are not bitwise the "
              f"kernels'")
    return (f"counted instances (their library waited {wait_s:.1f} s; "
            f"outputs bitwise the kernels'): " + " || ".join(parts))


# a crossing map of more than 2^26 pixels and orders (two orders of
# N_BIG_MAP^2): more than lists of int indices with a full region for each
# of their 16 bins can hold
N_BIG_MAP = 5800


def big_crossing_map(dev, a, incl, rmax, hit_small):
    """Phase 28's crossing map of N_BIG_MAP^2 pixels, orders 0 and 1 (2^26
    and more pixels and orders in one launch of each pass): each pass
    launched once, bitwise from run to run, r, g, phi and the delay
    finite, and each order's hit fraction within 0.01 of the 192^2 map's
    (`hit_small`).  Returns the text."""
    from sim5_tpu_torch.render import kernel_analytic as ka
    n = N_BIG_MAP
    check(2 * n * n > 2 ** 26, "the big map is not past 2^26")
    reset_analytic()
    m, sec = synced_seconds(lambda: ka.crossing_maps(a, incl, n, rmax,
                                                     (0, 1), dev))
    check(analytic_launches()[ka.CROSSING] == 1, f"the {n}^2 map launched "
          f"{launched(analytic_launches())}, not each pass once")
    again = ka.crossing_maps(a, incl, n, rmax, (0, 1), dev)
    check(same_bits(tensors_of(m), tensors_of(again)),
          f"crossing map {n}^2: two runs differ")
    del again
    for key in ("r", "g", "phi", "dt"):
        check(bool(torch.isfinite(m[key]).all()), f"crossing map {n}^2: "
              f"{key} not finite")
    frac = [float(m["hit"][j].double().mean()) for j in range(2)]
    small = [float(hit_small[j].double().mean()) for j in range(2)]
    check(all(abs(f - f0) <= 0.01 for f, f0 in zip(frac, small)),
          f"crossing map {n}^2: hit fractions {frac} against the "
          f"{N_HOTSPOT}^2 map's {small}")
    n_hits = int(m["hit"].sum())
    del m
    torch.cuda.empty_cache()
    return (f"{ka.CROSSING} {n}^2 orders 0 and 1 ({2 * n * n} pixels and "
            f"orders, {n_hits} hits), each pass launched once, bitwise from "
            f"run to run: {sec:.3f} s (host clock, the first call), hit "
            f"fractions {frac[0]:.4f} / {frac[1]:.4f} (the {N_HOTSPOT}^2 "
            f"map's {small[0]:.4f} / {small[1]:.4f})")


def pass_pattern(pv):
    """A regex of the pass `pv` (a key of kernel_analytic.LAUNCHES) in a
    profiler's kernel name, demangled or mangled."""
    kernel, _, args = pv.partition("<")
    args = [a.strip() for a in args.rstrip(">").split(",")]
    if kernel.startswith("crossing"):
        return rf"(?<![A-Za-z_]){kernel}(<|I)"
    t = args[0]
    if kernel == "seed_azimuth":
        return rf"(?<![A-Za-z_]){kernel}(<{t}\b|I{t[0]})"
    b = {"true": "1", "false": "0"}[args[1]]
    return rf"(?<![A-Za-z_]){kernel}(<{t}, {args[1]}\b|I{t[0]}Lb{b}E)"


def device_ms_by_kernel(fn, reps=6):
    """{kernel: device ms a launch} of the kernels and copies in fn(): the
    mean over the launches that torch.profiler's trace of `reps` calls
    holds (CUPTI: each kernel's own time on the card, without the host's
    gaps between launches, which CUDA events around a call include)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us and e.count and str(e.device_type).endswith("CUDA"):
            out[e.key] = us / 1e3 / e.count
    return out


def pass_device_ms(fn, expect, tries=4):
    """{pass: device ms a launch} of the analytic kernels' passes in fn()
    (each launched once a call; device_ms_by_kernel), profiled again, up
    to `tries` times, until the trace holds every pass of `expect`: the
    trace now and then holds no kernel at all."""
    from sim5_tpu_torch.render import kernel_analytic as ka
    for _ in range(tries):
        ms = device_ms_by_kernel(fn)
        out = {pv: v for k, v in ms.items() for pv in ka.LAUNCHES
               if re.search(pass_pattern(pv), k)}
        if set(expect) <= set(out):
            break
    return out


def phase_analytic_kernels(dev, name, lengths=None):
    """The crossing map (classify and hit passes) at example 07's 192^2,
    orders 0 and 1 in one launch of each pass, and the volume seed
    (geometry and azimuth passes) on example 07's spot (f64 and f32, with
    and without the azimuth) and example 11's torus (f64), each at 512^2,
    against their plain torch chains on the card; every output bitwise the
    same from run to run; each kernel's CUDA-event time (min of
    IMAGE_RUNS runs of ANALYTIC_REPS launches), each pass's alone, its
    plain chain's (host clock, synchronised), the launches, the bound from
    the operations the run's pixels execute (Carlson's rule; the fixed
    depth beside it) and the FP64 issue-slot bound; then the counted
    instances (analytic_counted).  Returns the kernels line's row of each
    main-path pass."""
    from sim5_tpu_torch import geodesic as gd
    from sim5_tpu_torch.render import image_grid, lightcurve
    from sim5_tpu_torch.render import kernel_analytic as ka
    ops_f = start_op_counts()
    rows, main, parts, outs = {}, {}, [], {}
    # the crossing map, both orders in one launch of each pass
    a, incl, rmax, n = SPOT["a"], SPOT["incl"], 2.5 * SPOT["r_spot"], \
        N_HOTSPOT
    cls_v, hit_v = ka.PASSES[ka.CROSSING]
    reset_analytic()
    m, _ = synced_seconds(lambda: ka.crossing_maps(a, incl, n, rmax, (0, 1),
                                                   dev))
    check(analytic_launches()[ka.CROSSING] == 1, "the two orders' crossing "
          f"map launched {launched(analytic_launches())}, not each pass once")
    again = ka.crossing_maps(a, incl, n, rmax, (0, 1), dev)
    check(same_bits(tensors_of(m), tensors_of(again)),
          "crossing map: two runs differ")
    outs["crossing"] = m
    plain, plain_s = synced_seconds(lambda: [
        lightcurve._crossing_map_unanchored(a, incl, n, rmax, o, dev)
        for o in (0, 1)])
    g = gd.geodesic_init_inf(incl, a, *image_grid(n, n, rmax, device=dev))
    err_cls, err_hit, texts = 0.0, 0.0, []
    n_hits = 0
    for j, p in enumerate(plain):
        hit, tag = p["hit"], f"crossing map order {j}"
        n_hits += int(hit.sum())
        check(torch.equal(m["hit"][j], hit), f"{tag}: hit sets differ "
              f"({int((m['hit'][j] != hit).sum())} pixels)")
        far = far_bound(g, p["r"])
        w_r = worst((m["r"][j] - p["r"]).abs(),
                    1e-12 * p["r"].abs() + far, torch.ones_like(hit))
        rel_r = float(((m["r"][j] - p["r"]).abs() / p["r"].abs()).max())
        rel_g = float(((m["g"][j] - p["g"]).abs() / p["g"].abs())[hit].max())
        check(w_r[0] <= 1.0 and rel_g <= 1e-12, f"{tag}: r {rel_r:.3e} "
              f"relative ({w_r[0]:.3f} of 1e-12 + far_bound), g {rel_g:.3e} "
              f"(gate 1e-12)")
        for key in ("phi", "g", "dt"):
            check(torch.equal(m[key][j][~hit], p[key][~hit]),
                  f"{tag}: {key} of the pixels that are no hit")
        w_phi = worst((m["phi"][j] - p["phi"]).abs(), phi_bound(g, p["phi"]),
                      hit)
        w_dt = worst((m["dt"][j] - p["dt"]).abs(),
                     time_bound(g, p["dt"], lightcurve.R_FAR) + far, hit)
        check(w_phi[0] <= 1.0 and w_dt[0] <= 1.0, f"{tag}: phi "
              f"{w_phi[1]:.3e} ({w_phi[0]:.3f} of its bound), delay "
              f"{w_dt[1]:.3e} ({w_dt[0]:.3f})")
        err_cls = max([err_cls] + [float((m[k][j] - p[k]).abs()[hit].max())
                                   for k in ("r", "g")])
        err_hit = max(err_hit, float((m["phi"][j] - p["phi"]).abs()[hit]
                                     .max()))
        texts.append(f"order {j}: hit {float(hit.double().mean()):.4f}, r "
                     f"{rel_r:.3e} ({w_r[0]:.3f} of its bound, max r "
                     f"{float(p['r'][hit].max()):.4e}) g {rel_g:.3e} "
                     f"relative, phi "
                     f"{w_phi[1]:.3e} ({w_phi[0]:.3f} of bound), delay "
                     f"{w_dt[1]:.3e} ({w_dt[0]:.3f})")
    ms = event_runs(lambda: ka.crossing_maps(a, incl, n, rmax, (0, 1), dev),
                    ANALYTIC_REPS)
    dms = pass_device_ms(lambda: ka.crossing_maps(a, incl, n, rmax, (0, 1),
                                                  dev), (cls_v, hit_v))
    check(set(dms) == {cls_v, hit_v}, f"the profiler saw {sorted(dms)}")
    plain_ms = plain_s * 1e3
    rows[cls_v] = dict(ms=dms[cls_v], plain_ms=plain_ms, max_abs_err=err_cls,
                       out_bytes=2 * n * n * 33 + n_hits * HIT_ENTRY_BYTES,
                       ops_key=("crossing", True), part=0)
    rows[hit_v] = dict(ms=dms[hit_v], plain_ms=plain_ms, max_abs_err=err_hit,
                       out_bytes=n_hits * (HIT_ENTRY_BYTES + 16),
                       ops_key=("crossing", True), part=1)
    rows[ka.CROSSING] = dict(ms=ms[0], plain_ms=plain_ms,
                             max_abs_err=max(err_cls, err_hit),
                             out_bytes=2 * n * n * 33,
                             ops_key=("crossing", True), part=None,
                             pr14_key=("crossing", False))
    main[cls_v], main[hit_v] = rows[cls_v], rows[hit_v]
    parts.append(f"{ka.CROSSING} {n}^2 orders 0 and 1, each pass launched "
                 f"once, bitwise from run to run: {spread(ms)} ms (CUDA "
                 f"events, min / median / max of {IMAGE_RUNS} runs of "
                 f"{ANALYTIC_REPS}, host gaps included); on the card "
                 f"(profiler) {cls_v} {dms[cls_v]:.4f}, {hit_v} "
                 f"{dms[hit_v]:.4f} ({n_hits} hits); plain "
                 f"{plain_s:.3f} s | " + "; ".join(texts))
    parts.append(big_crossing_map(dev, a, incl, rmax, m["hit"]))
    # the seeds
    f64_plain = {}
    for case, cfg, dt, axi in SEED_CASES:
        args = (cfg["a"], cfg["incl"], 0.0, N_VOL_PIX, cfg["rmax"],
                cfg["r_start"], axi, dt)
        v = ka.SEEDS[dt, not axi]
        tag = f"{case} {v}"
        reset_analytic()
        (x0, k, ok), _ = synced_seconds(lambda: ka.volume_seed_rays(*args,
                                                                    dev))
        check(analytic_launches()[v] == 1, f"{tag}: launched "
              f"{launched(analytic_launches())}")
        check(same_bits([x0, k, ok], ka.volume_seed_rays(*args, dev)),
              f"{tag}: two runs differ")
        if case == "spot" and dt == torch.float64 and not axi:
            outs["seed"] = (x0, k, ok)
        (px0, pk, pok), p_s = synced_seconds(
            lambda: lightcurve._volume_seed_plain(*args, dev))
        err_phi = 0.0
        if dt == torch.float64:
            f64_plain[case, axi] = (px0, pk, pok)
            check(torch.equal(ok, pok), f"{tag}: valid sets differ "
                  f"({int((ok != pok).sum())} pixels)")
            check(torch.equal(x0[..., 0], px0[..., 0]), f"{tag}: t0")
            gs = gd.geodesic_init_inf(cfg["incl"], cfg["a"], *image_grid(
                N_VOL_PIX, N_VOL_PIX, cfg["rmax"], device=dev))
            b_r, b_m, b_k = seed_bounds(gs, px0, pk)
            ws = [worst((x0[..., c] - px0[..., c]).abs(), b, ok)
                  for c, b in ((1, b_r), (2, b_m))]
            ws += [worst((k[..., c] - pk[..., c]).abs(), b_k[..., c], ok)
                   for c in range(4)]
            check(max(w[0] for w in ws) <= 1.0, f"{tag}: r0, m0, k0-k3 "
                  "against their bounds: " + ", ".join(
                      f"{w[1]:.3e} ({w[0]:.3f})" for w in ws))
            check(torch.equal(x0[~ok], px0[~ok]) and torch.equal(k[~ok],
                                                                 pk[~ok]),
                  f"{tag}: the invalid pixels' dummy ray")
            text = ("r0, m0, k0-k3 " + ", ".join(
                f"{w[1]:.3e} ({w[0]:.3f} of bound)" for w in ws))
            if not axi:
                w = worst((x0[..., 3] - px0[..., 3]).abs(),
                          phi_bound(gs, px0[..., 3]), ok)
                check(w[0] <= 1.0, f"{tag}: phi0 {w[1]:.3e} ({w[0]:.3f} of "
                      f"its bound)")
                text += f", phi0 {w[1]:.3e} ({w[0]:.3f} of bound)"
                err_phi = w[1]
            err = max(float((x0[..., :3] - px0[..., :3]).abs()[ok].max()),
                      float((k - pk).abs()[ok].max()))
        else:
            # against the f64 plain chain, no further than 2x the plain f32
            # chain's own distance (+ 1e-6 of each field's scale): both
            # share the f32 geometry's rounding (the quartic's roots, the
            # inversions at r_start), the kernel differs by libm's ulps
            wx0, wk, wok = f64_plain[case, axi]
            mism = int((ok != wok).sum())
            check(mism <= ok.numel() // 100 and int((ok != pok).sum())
                  <= ok.numel() // 100, f"{tag}: valid sets differ on "
                  f"{mism} pixels from the f64 chain's")
            both = ok & wok & pok
            ratio = 0.0
            for got, pl, want in ((x0, px0, wx0), (k, pk, wk)):
                for c in range(4):
                    scale = float(want[..., c][both].abs().max()) or 1.0
                    e_k = float((got[..., c].double() - want[..., c]).abs()
                                [both].max())
                    e_p = float((pl[..., c].double() - want[..., c]).abs()
                                [both].max())
                    check(e_k <= 2.0 * e_p + 1e-6 * scale, f"{tag}: field "
                          f"{c} {e_k:.3e} from f64, the plain f32 {e_p:.3e}")
                    ratio = max(ratio, e_k / (2.0 * e_p + 1e-6 * scale))
            text = (f"vs the f64 chain {ratio:.3f} of its gate (2x the plain "
                    f"f32's distance + 1e-6 of scale), valid sets differ on "
                    f"{mism}")
            err = max(float((x0.double() - px0.double())[..., :3].abs()
                            [ok & pok].max()), float(
                (k.double() - pk.double()).abs()[ok & pok].max()))
            err_phi = float((x0.double() - px0.double())[..., 3].abs()
                            [ok & pok].max())
        ms = event_runs(lambda: ka.volume_seed_rays(*args, dev),
                        ANALYTIC_REPS)
        passes = ka.PASSES[v]
        key = (case, dt, axi, True)
        n_valid = int(ok.sum())
        item = x0.element_size()
        out_bytes = ok.numel() * (8 * item + 1)
        rows[tag] = dict(ms=ms[0], plain_ms=p_s * 1e3,
                         max_abs_err=max(err, err_phi), out_bytes=out_bytes,
                         ops_key=key, part=None,
                         pr14_key=(case, dt, axi, False)
                         if (case, dt, axi) == ("spot", torch.float64, False)
                         else None)
        dms = pass_device_ms(lambda: ka.volume_seed_rays(*args, dev), passes)
        check(set(dms) == set(passes), f"{tag}: the profiler saw "
              f"{sorted(dms)}")
        text_passes = "; on the card (profiler) " + ", ".join(
            f"{pv} {dms[pv]:.4f}" for pv in passes)
        if len(passes) == 2:
            entry = SEED_ENTRY_BYTES[dt]
            rows[f"{case} {passes[0]}"] = dict(
                ms=dms[passes[0]], plain_ms=p_s * 1e3, max_abs_err=err,
                out_bytes=out_bytes + n_valid * entry, ops_key=key, part=0)
            rows[f"{case} {passes[1]}"] = dict(
                ms=dms[passes[1]], plain_ms=p_s * 1e3, max_abs_err=err_phi,
                out_bytes=n_valid * (entry + 4 * item), ops_key=key, part=1)
        else:
            rows[f"{case} {passes[0]}"] = dict(rows[tag], ms=dms[passes[0]],
                                               part=0)
        if dt == torch.float64 and (case == "torus" or not axi):
            for pv in passes:
                main[pv] = rows[f"{case} {pv}"]
        parts.append(f"{tag} {N_VOL_PIX}^2, each pass launched once, "
                     f"bitwise from run to run: {spread(ms)} ms (host gaps "
                     f"included){text_passes}, plain {p_s:.3f} s, valid "
                     f"{float(ok.double().mean()):.4f}, {text}")
    counted_text = analytic_counted(dev, outs)
    t0 = time.perf_counter()
    ops = ops_f.result()
    ops_wait = time.perf_counter() - t0
    bounds = []
    for key, row in rows.items():
        o = ops[row["ops_key"]]
        j = row["part"]
        po = o if j is None else o["passes"][j]
        pf = o["fn"] if j is None else o["fn_passes"][j]
        row["bound_ms"], row["bound_by"] = analytic_bound(po, row["out_bytes"])
        row["issue_ms"] = issue_bound(po, pf, lengths)
        issue = ("not measured (no SASS lengths)" if row["issue_ms"] is None
                 else f"{row['issue_ms']:.4f} ms, "
                      f"{row['issue_ms'] / row['ms']:.3f} of the time")
        text = (f"{key}: {row['bound_ms']:.4f} ms ({row['bound_by']}; "
                f"{row['bound_ms'] / row['ms']:.3f} of the time), FP64 issue "
                f"slots {issue}; ops add/mul/div/sqrt/transcendental "
                f"{ops_text(po)}")
        if row.get("pr14_key"):
            old = ops[row["pr14_key"]]
            f_new = sum(o["f64"].values())
            f_old = sum(old["f64"].values())
            text += (f"; at the fixed depth {ops_text(old)} (f64 "
                     f"{f_new / f_old:.3f} of it; issue slots "
                     + ("not measured" if lengths is None or not lengths else
                        f"{issue_bound(old, old['fn'], lengths):.4f} ms")
                     + "); levels at Carlson's rule: " + ", ".join(
                         f"{c} {v['levels'] / v['calls']:.2f} (deepest "
                         f"{v['deepest']})" for c, v in o["levels"].items()
                         if v["calls"]))
        bounds.append(text)
    print(f"phase 28 analytic kernels vs their plain chains on the card "
          f"({name}): {analytic_attributes_text()} | " + " | ".join(parts)
          + " | bounds (counted "
          f"operations over 34 / 67 TFLOP/s f64 / f32, or bytes over 3.35 "
          f"TB/s; FP64 issue slots: + and x one, /, sqrt and transcendentals"
          f" the FP64 (FP32) pipe instructions of their SASS, over 17 / 33.5 "
          f"T lane instructions/s; the "
          f"counter waited {ops_wait:.2f} s): " + "; ".join(bounds)
          + " | " + counted_text, flush=True)
    return main


# --- phases 16-18: the equatorial thin-disk products (the shadow of
# example 09, the polarized image and spectrum of examples 06 and 10, the
# line profile and the transfer function): eager f64 torch, no kernel

SHADOW = dict(a=0.998, incl=math.radians(80.0), rmax=10.0)   # example 09
N_SHADOW = 512
POL = dict(a=0.9, incl=math.radians(70.0))                   # examples 06, 10
N_POL_IMAGE = 256
N_POL_SPEC = 192
POL_E = np.geomspace(0.3, 10.0, 20)
LINE = dict(a=0.9, incl=math.radians(45.0))                  # line_profile
N_LINE = 256
TRANSFER = dict(a=0.5, incl=math.radians(60.0),
                r_edges=np.geomspace(3.0, 50.0, 9))
N_TRANSFER = 384
N_PRODUCT_CMP = 64       # the card against the CPU
ENTRY_RUNS = 5           # warm host-clock calls of each entry point
US_PER_OP = 7.2          # the eager engine's launch cost an op (PERF.md §5)
MASK_EDGE = 1e-10        # a lane whose mask differs sits this close to it


def inner_emissivity(r):
    """Example 09's emissivity inside the ISCO."""
    return 1e22 * r ** -3


def entry_times(fn):
    """(first call, the min of ENTRY_RUNS warm calls) in seconds on the
    synchronised host clock, and the first call's result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    warm = []
    for _ in range(ENTRY_RUNS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    return first, min(warm), out


def count_ops(fn):
    """fn()'s result and the number of torch operations it dispatched that
    write a tensor (views excluded): on the card each is a kernel launch
    of the eager engine."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if all(r.alias_info is None or r.alias_info.is_write
                   for r in func._schema.returns):
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, Count.n


def launch_text(ops, warm_s):
    """The op count, the time an op, and the share of the warm time that
    ops x US_PER_OP accounts for."""
    return (f"{ops} ops (CPU count), {warm_s / ops * 1e6:.2f} us an op, "
            f"ops x {US_PER_OP} us = {ops * US_PER_OP * 1e-6 / warm_s:.3f} "
            f"of the time")


def mask_flips(tag, got, want, dist):
    """The number of lanes where the card's mask `got` differs from the
    CPU's `want`; each must sit within MASK_EDGE (relative, `dist`, from
    the CPU's values) of the mask's threshold."""
    diff = got.cpu() != want
    n = int(diff.sum())
    if n:
        far = float(dist[diff].max())
        check(far <= MASK_EDGE, f"{tag}: {n} lanes differ between the card "
              f"and the CPU, one {far:.3e} (relative) from the threshold")
    return n


def rel_err(got, want, sel, scale=None):
    """max |got - want| / |scale| over `sel` (scale defaults to want; equal
    values count 0 whatever the scale)."""
    scale = want if scale is None else scale
    diff = (got.cpu() - want).abs()
    d = torch.where(diff == 0, 0.0, diff / scale.abs())[sel]
    return float(d.max()) if d.numel() else 0.0


def golden_err(tag, got, want, rtol, atol):
    """Check the card's values against a golden table where the golden is
    finite (test_core.py / test_polarization.py's rule); returns the
    largest |got - want| / (atol + rtol |want|)."""
    want = torch.as_tensor(want, dtype=torch.float64)
    got = got.cpu().reshape(want.shape)
    fin = torch.isfinite(want)
    ratio = float(((got - want).abs() / (atol + rtol * want.abs()))[fin].max())
    check(ratio <= 1.0, f"golden {tag} on the card: {ratio:.3f} of its "
          f"tolerance (rtol {rtol}, atol {atol})")
    return ratio


def shadow_geometry(dev, npix):
    """The shadow's thresholds at npix^2 on `dev`: the radius of the first
    crossing and its cut 1.01 r_h, the periastron and the horizon."""
    from sim5_tpu_torch import geodesic as gd
    from sim5_tpu_torch.core import r_bh
    from sim5_tpu_torch.render import image_grid
    alpha, beta = image_grid(npix, npix, SHADOW["rmax"], device=dev)
    g = gd.geodesic_init_inf(SHADOW["incl"], SHADOW["a"], alpha, beta)
    r0 = gd.geodesic_position_rad(g, gd.geodesic_find_midplane_crossing(g))
    return r0, 1.01 * r_bh(g.a), g.rp, r_bh(g.a)


def plunge_noise(im):
    """The relative spread of the plunging g-factor of each pixel of a CPU
    image when its radius or one of its motion constants moves by 1 to 4
    ulps: its rounding noise, which the card's ulp-level differences in r,
    l and q reach too.  Near the ISCO u_r^2 is a difference of terms up to
    ~1e9 times larger (the plunging gas starts at rest radially), and
    E k^t - L k^phi cancels by ~10 (measured on the CPU at 64^2)."""
    from sim5_tpu_torch import geodesic as gd
    from sim5_tpu_torch.core import photon_momentum, r_ms
    from sim5_tpu_torch.render import image_grid
    from sim5_tpu_torch.render.shadow import gfactor_plunge
    npix = im.g.shape[0]
    alpha, beta = image_grid(npix, npix, SHADOW["rmax"], device="cpu")
    g = gd.geodesic_init_inf(SHADOW["incl"], SHADOW["a"], alpha, beta)
    inside = im.hit & (im.r < r_ms(g.a))
    r = torch.where(inside, im.r, r_ms(g.a))
    one = torch.ones_like(r)

    def gp(r, l, q):
        k = photon_momentum(g.a, r, torch.zeros_like(r), l, q, one, one)
        return gfactor_plunge(r, g.a, torch.where(torch.isfinite(k), k, 0.0))

    base = gp(r, g.l, g.q)
    N = torch.zeros_like(r)
    for ulps in (-4, -2, -1, 1, 2, 4):
        for i in range(3):
            x = [r, g.l, g.q]
            x[i] = x[i] * (1.0 + ulps * EPS64)
            N = torch.maximum(N, ((gp(*x) - base) / base).abs())
    return torch.where(inside & torch.isfinite(N), N, 0.0), inside


def phase_shadow(dev):
    """Example 09 at its full size: render_bh_image at 512^2 (a = 0.998,
    80 deg, rmax 10, nt_setup(10, a, 0.1, 0.1), inner emissivity 1e22
    r^-3), timed; the card against the CPU at 64^2; tests/test_shadow.py's
    gates; the contravariant metric against kerr.txt."""
    from sim5_tpu_torch.core import kerr_metric_contravariant, r_ms
    from sim5_tpu_torch.disk import nt_setup
    from sim5_tpu_torch.render import render_bh_image
    a, incl, rmax = SHADOW["a"], SHADOW["incl"], SHADOW["rmax"]

    def shadow(npix, device):
        return render_bh_image(a, incl, npix, npix, rmax=rmax,
                               disk=nt_setup(10.0, a, 0.1, 0.1,
                                             device=device),
                               inner_emissivity=inner_emissivity)

    first, warm, im = entry_times(lambda: shadow(N_SHADOW, dev))
    check(im.flux.device.type == "cuda"
          and render_bh_image(a, incl, 16, 16).g.device.type == "cuda",
          "the shadow did not run on the card (given the disk's device, or "
          "no device)")
    check(bool(torch.isfinite(im.flux).all()) and bool((im.flux >= 0).all())
          and bool((im.flux[~im.hit] == 0).all()),
          "512^2 shadow: flux not finite, >= 0 and 0 off the hits")
    cap_frac = float(im.captured.double().mean())
    g_hit = im.g[im.hit]
    # the card against the CPU
    n = N_PRODUCT_CMP
    k = shadow(n, dev)
    c, ops = count_ops(lambda: shadow(n, "cpu"))
    r0, cut, rp, rh = shadow_geometry("cpu", n)
    flips = mask_flips("shadow hit", k.hit, c.hit,
                       ((r0 - cut).abs() / cut).nan_to_num(math.inf))
    flips += mask_flips("shadow captured", k.captured, c.captured,
                        (rp - rh).abs() / rh)
    both = k.hit.cpu() & c.hit
    noise, inside = plunge_noise(c)
    # the card's radius and motion constants differ from the CPU's by a few
    # ulps (phase 13 measures r to 4e-15): the plunging g moves by its
    # rounding noise (the JAX package and the port differ by up to 1.4 of
    # it on the CPU at 64^2)
    g_bound = 1e-12 + 16.0 * noise
    errs = dict(r=rel_err(k.r, c.r, both))
    g_ratio = rel_err(k.g, c.g, both, c.g * g_bound)
    f_ratio = rel_err(k.flux, c.flux, both, c.flux * (4.0 * g_bound + 3e-13))
    check(errs["r"] <= 1e-12, f"shadow r: card vs CPU {errs['r']:.3e} > 1e-12")
    check(g_ratio <= 1.0 and f_ratio <= 1.0, f"shadow g / flux: card vs CPU "
          f"{g_ratio:.3f} / {f_ratio:.3f} of their bounds")
    g_out = rel_err(k.g, c.g, both & ~inside)
    # tests/test_shadow.py's gates, on the card
    sch = render_bh_image(1e-3, math.radians(60.0), 256, 256, rmax=10.0,
                          device=dev)
    area = float(sch.captured.double().mean()) * 400.0
    check(abs(area - 27.0 * math.pi) / (27.0 * math.pi) < 0.02,
          f"Schwarzschild shadow area {area:.4f} vs 27 pi")
    mf = render_bh_image(a, incl, 128, 128, rmax=8.0,
                         disk=nt_setup(10.0, a, 0.1, 0.1, device=dev),
                         inner_emissivity=inner_emissivity)
    rms = float(r_ms(torch.tensor(a, dtype=torch.float64)))
    check(int((mf.captured & mf.hit).sum()) > 0
          and bool(torch.isfinite(mf.flux).all())
          and bool((mf.flux >= 0).all())
          and float(mf.flux[mf.hit & (mf.r < rms)].max()) > 0
          and bool((mf.flux[~mf.hit] == 0).all()),
          "tests/test_shadow.py masks-and-flux gate on the card")
    d = golden_rows("kerr.txt", "imetric")
    gi = kerr_metric_contravariant(*(torch.tensor(d[:, i], device=dev)
                                     for i in range(3)))
    gold = golden_err("imetric", torch.stack(
        [gi.g00, gi.g11, gi.g22, gi.g33, gi.g03], -1), d[:, 3:8], 1e-12,
        1e-13)
    print(f"phase 16 black-hole shadow (example 09: a={a}, incl "
          f"{math.degrees(incl):.0f}, {N_SHADOW}^2, rmax {rmax}, NT disk "
          f"outside the ISCO, 1e22 r^-3 inside): first call {first:.4f} s, "
          f"warm {warm * 1e3:.3f} ms (min of {ENTRY_RUNS}, host clock, "
          f"synchronised); {launch_text(ops, warm)} | shadow fraction "
          f"{cap_frac:.4f}; g range on emission [{float(g_hit.min()):.3f}, "
          f"{float(g_hit.max()):.3f}] | card vs CPU at {n}^2: masks differ on "
          f"{flips} lanes, r {errs['r']:.3e} relative (gate 1e-12), g "
          f"outside the ISCO {g_out:.3e}, g and flux {g_ratio:.3f} / "
          f"{f_ratio:.3f} of their bounds (1e-12 + 16 N, N the plunging g's "
          f"spread over 1-4 ulps of r, l, q on the CPU, up to "
          f"{float(noise.max()):.3e}; flux 4x + 3e-13) | "
          f"Schwarzschild shadow area {area:.4f} (27 pi = "
          f"{27 * math.pi:.4f}, gate 2%); masks-and-flux gate at 128^2 | "
          f"imetric golden on the card {gold:.3f} of rtol 1e-12", flush=True)
    return dict(first=first, warm=warm, ops=ops)


def pol_gates(dev):
    """tests/test_polarized_spectrum.py's face-on and inclined degree
    gates at npix 96, on `dev`: (face-on max degree, inclined max degree,
    the Chandrasekhar bound)."""
    from sim5_tpu_torch.disk import nt_setup
    from sim5_tpu_torch.render import chandrasekhar_poldeg, polarized_spectrum
    E = np.geomspace(0.3, 8.0, 12)
    disk = nt_setup(10.0, 0.5, 0.1, 0.1, device=dev)
    degs = []
    for inc in (3.0, 75.0):
        I, Q, U = (v.cpu().numpy() for v in polarized_spectrum(
            disk, math.radians(inc), E, npix=96))
        ok = I > 1e-12 * I.max()
        deg = np.where(ok, np.hypot(Q, U) / np.where(ok, I, 1.0), 0.0)
        check(I.max() > 0 and np.isfinite(I).all(),
              f"polarized spectrum at {inc} deg not finite and positive")
        degs.append(float(deg[I > 1e-6 * I.max()].max()))
    bound = float(chandrasekhar_poldeg(math.cos(math.radians(75.0))))
    check(degs[0] < 5e-3, f"face-on degree {degs[0]:.3e} >= 5e-3")
    check(5e-3 < degs[1] < bound, f"75 deg degree {degs[1]:.4f} not in "
          f"(5e-3, {bound:.4f})")
    return degs + [bound]


def phase_polarized(dev):
    """Examples 06 and 10 at their full sizes: render_polarized_image at
    256^2 and polarized_spectrum at 192^2 x 20 energies (a = 0.9, 70 deg),
    timed; each card against the CPU at 64^2; the degree gates; the
    goldens tazm, tsurf, wp, pvec and prot on the card."""
    from sim5_tpu_torch import core, polarization as pol
    from sim5_tpu_torch.disk import nt_setup
    from sim5_tpu_torch.render import (image_grid, polarized_spectrum,
                                       render_polarized_image)
    from sim5_tpu_torch import geodesic as gd
    a, incl = POL["a"], POL["incl"]
    disk = nt_setup(10.0, a, 0.1, 0.1, device=dev)
    cdisk = nt_setup(10.0, a, 0.1, 0.1, device="cpu")
    img_first, img_warm, (I, Q, U) = entry_times(
        lambda: render_polarized_image(disk, incl, N_POL_IMAGE, N_POL_IMAGE))
    spec_first, spec_warm, (IE, QE, UE) = entry_times(
        lambda: polarized_spectrum(disk, incl, POL_E, npix=N_POL_SPEC))
    check(I.device.type == "cuda" and IE.device.type == "cuda"
          and render_polarized_image(nt_setup(10.0, a, 0.1, 0.1), incl, 16,
                                     16)[0].device.type == "cuda",
          "the polarized products did not run on the card (a disk built "
          "with no device is the card's)")
    for tag, t in (("I", I), ("Q", Q), ("U", U), ("I_E", IE), ("Q_E", QE),
                   ("U_E", UE)):
        check(bool(torch.isfinite(t).all()), f"polarized {tag} not finite")
    check(bool((IE > 0).all()), "polarized spectrum I_E not positive")
    Is, Qs, Us = float(I.sum()), float(Q.sum()), float(U.sum())
    int_deg = math.hypot(Qs, Us) / Is
    int_ang = math.degrees(float(pol.stokes_polang(
        torch.tensor(Is), torch.tensor(Qs), torch.tensor(Us))))
    # the card against the CPU, image
    n = N_PRODUCT_CMP
    Ik, Qk, Uk = render_polarized_image(disk, incl, n, n)
    (Ic, Qc, Uc), img_ops = count_ops(
        lambda: render_polarized_image(cdisk, incl, n, n))
    alpha, beta = image_grid(n, n, cdisk.rms - 1e-3 + 12.0, device="cpu")
    g = gd.geodesic_init_inf(incl, cdisk.a, alpha, beta)
    r = gd.geodesic_position_rad(g, gd.geodesic_find_midplane_crossing(g))
    # hit from r >= rms - 1e-3, and I > 0 from nt_flux's r > rms
    edge = torch.minimum((r - (cdisk.rms - 1e-3)).abs(), (r - cdisk.rms).abs())
    flips = mask_flips("polarized image", Ik > 0, Ic > 0,
                       (edge / cdisk.rms).nan_to_num(math.inf))
    on = (Ik.cpu() > 0) & (Ic > 0)
    img_errs = [rel_err(Ik, Ic, on), rel_err(Qk, Qc, on, Ic),
                rel_err(Uk, Uc, on, Ic)]
    check(max(img_errs) <= 1e-11, f"polarized image card vs CPU: I, Q, U "
          f"{img_errs} (of I) > 1e-11")
    # the card against the CPU, spectrum (sums in another order)
    Sk = polarized_spectrum(disk, incl, POL_E, npix=n)
    Sc, spec_ops = count_ops(
        lambda: polarized_spectrum(cdisk, incl, POL_E, npix=n))
    all_e = torch.ones(len(POL_E), dtype=torch.bool)
    spec_errs = [rel_err(Sk[0], Sc[0], all_e),
                 rel_err(Sk[1], Sc[1], all_e, Sc[0]),
                 rel_err(Sk[2], Sc[2], all_e, Sc[0])]
    check(max(spec_errs) <= 1e-12, f"polarized spectrum card vs CPU: I_E, "
          f"Q_E, U_E {spec_errs} (of I_E) > 1e-12")
    degs = pol_gates(dev)
    # the goldens on the card
    t = lambda v: torch.tensor(v, device=dev)       # noqa: E731
    gold = {}
    d = golden_rows("kerr.txt", "tazm")
    m = core.kerr_metric(t(d[:, 0]), t(d[:, 1]), t(d[:, 2]))
    gold["tazm"] = golden_err("tazm", core.tetrad_azimuthal(m, t(d[:, 3])).e,
                              d[:, 4:20], 1e-12, 1e-13)
    d = golden_rows("kerr.txt", "tsurf")
    m = core.kerr_metric(t(d[:, 0]), t(d[:, 1]), t(d[:, 2]))
    gold["tsurf"] = golden_err("tsurf", core.tetrad_surface(
        m, t(d[:, 3]), 0.1, 0.05).e, d[:, 4:20], 1e-12, 1e-13)
    d = golden_rows("polarization.txt", "wp")
    m = core.kerr_metric(t(d[:, 0]), t(d[:, 1]), t(d[:, 2]))
    wp = pol.polarization_constant(t(d[:, 3:7]), t(d[:, 7:11]), m)
    gold["wp"] = max(golden_err("wp", wp[i], d[:, 11 + i], 1e-10, 1e-12)
                     for i in range(2))
    f = pol.polarization_vector(t(d[:, 3:7]), t(d[:, 11]), t(d[:, 12]), m)
    gold["pvec"] = golden_err("pvec", f, golden_rows("polarization.txt",
                                                      "pvec"), 1e-8, 1e-9)
    d = golden_rows("polarization.txt", "prot")
    w1, w2 = pol.polarization_constant_infinity(t(d[:, 0]), t(d[:, 2]),
                                                t(d[:, 3]), t(d[:, 1]))
    chi = pol.polarization_angle_rotation(t(d[:, 0]), t(d[:, 1]), t(d[:, 2]),
                                          t(d[:, 3]), w1, w2)
    gold["prot"] = max(golden_err("prot wp1", w1, d[:, 4], 1e-12, 0.0),
                       golden_err("prot wp2", w2, d[:, 5], 1e-12, 0.0),
                       golden_err("prot chi", chi, d[:, 6], 1e-10, 1e-12))
    IEn, QEn, UEn = (v.cpu().numpy() for v in (IE, QE, UE))
    table = "; ".join(
        f"{e:.3f} {i:.6e} {dg:.5f} {an:.3f}" for e, i, dg, an in zip(
            POL_E, IEn, np.hypot(QEn, UEn) / np.maximum(IEn, 1e-300),
            0.5 * np.degrees(np.arctan2(UEn, QEn))))
    print(f"phase 17 polarized image and spectrum (examples 06 and 10: a={a}"
          f", incl {math.degrees(incl):.0f}): image {N_POL_IMAGE}^2 first "
          f"call {img_first:.4f} s, warm {img_warm * 1e3:.3f} ms; "
          f"{launch_text(img_ops, img_warm)} | spectrum {N_POL_SPEC}^2 x "
          f"{len(POL_E)} energies first call {spec_first:.4f} s, warm "
          f"{spec_warm * 1e3:.3f} ms; {launch_text(spec_ops, spec_warm)} "
          f"(min of {ENTRY_RUNS}, host clock, synchronised) | example 06: "
          f"pixels on disk {int((I > 0).sum())}, integrated poldeg "
          f"{int_deg:.4f}, polangle {int_ang:.2f} deg | card vs CPU at "
          f"{n}^2: image masks differ on {flips} lanes, I {img_errs[0]:.3e} "
          f"relative, Q {img_errs[1]:.3e} and U {img_errs[2]:.3e} of I "
          f"(gate 1e-11); spectrum I_E {spec_errs[0]:.3e}, Q_E "
          f"{spec_errs[1]:.3e}, U_E {spec_errs[2]:.3e} of I_E (gate 1e-12) | "
          f"degree gates (a=0.5, npix 96): face-on {degs[0]:.3e} (< 5e-3), "
          f"75 deg {degs[1]:.4f} (in (5e-3, {degs[2]:.4f})) | goldens on "
          f"the card, of their tolerances: " + ", ".join(
              f"{k} {v:.3f}" for k, v in gold.items())
          + f" | example 10 (E keV, I_E erg/s/cm2/keV, degree, angle deg): "
          + table, flush=True)
    return dict(img_first=img_first, img_warm=img_warm, img_ops=img_ops,
                spec_first=spec_first, spec_warm=spec_warm,
                spec_ops=spec_ops)


def g_bin_edge(gf, bins):
    """Relative distance of each pixel's (g - lo)/(hi - lo) bins to the
    nearest bin edge: where the card's g-bin may differ from the CPU's."""
    x = (gf - 0.2) / 1.2 * bins
    return ((x - x.round()).abs() / x.abs().clamp(min=1.0))


def line_map_edges(a, incl, npix, r_in, r_out, order, r_edges=()):
    """The CPU's relative distance of each pixel of disk_g_map to the
    thresholds of its hit mask (r_in, r_out) and to the radial bin edges
    `r_edges`: the raw crossing radius, recomputed."""
    from sim5_tpu_torch import geodesic as gd
    from sim5_tpu_torch.core import r_ms
    from sim5_tpu_torch.render import image_grid
    r_in = float(r_ms(torch.tensor(a, dtype=torch.float64))) \
        if r_in is None else r_in
    r_out = 400.0 if r_out is None else r_out
    alpha, beta = image_grid(npix, npix, min(r_out * 1.1, 60.0),
                             device="cpu")
    g = gd.geodesic_init_inf(incl, a, alpha, beta)
    r = gd.geodesic_position_rad(g, gd.geodesic_find_midplane_crossing(
        g, order))
    dist = [((r - e).abs() / e) for e in (r_in, r_out) + tuple(r_edges)]
    return torch.stack(dist).min(0).values.nan_to_num(math.inf)


def product_flips(tag, mk, mc, edge, bins, r_bins=None):
    """The pixels of a disk_g_map whose hit mask or bins differ between
    the card (`mk`) and the CPU (`mc`), each checked against `edge` (the
    radial thresholds) or its g-bin edge; returns (count, their mask)."""
    from sim5_tpu_torch.render.lineprofile import _g_index
    both = mk[2].cpu() & mc[2]
    n = mask_flips(f"{tag} hit", mk[2], mc[2], edge)
    gk, gc = (_g_index(m[1], 0.2, 1.4, bins).cpu() * both for m in (mk, mc))
    n += mask_flips(f"{tag} g-bin", gk, gc, g_bin_edge(mc[1], bins))
    moved = (mk[2].cpu() != mc[2]) | (gk != gc)
    if r_bins is not None:
        rk, rc = (torch.searchsorted(r_bins.to(m[0].device), m[0]).cpu()
                  * both for m in (mk, mc))
        n += mask_flips(f"{tag} r-bin", rk, rc, edge)
        moved |= rk != rc
    return n, moved


def phase_lineprofile(dev):
    """line_profile (256^2, orders 0 and 1, 200 bins; a = 0.9, 45 deg)
    and transfer_function (384^2, 64 g-bins, 8 radial bins over 3-50;
    a = 0.5, 60 deg) at their default sizes, timed; the card against the
    CPU at 64^2 and the card against itself (atomic sums); the
    tests/test_driver.py gates."""
    from sim5_tpu_torch.render import (disk_g_map, line_profile,
                                       transfer_function)
    a, incl = LINE["a"], LINE["incl"]
    ta, ti, edges = TRANSFER["a"], TRANSFER["incl"], TRANSFER["r_edges"]
    lp_first, lp_warm, (gc, prof) = entry_times(
        lambda: line_profile(a, incl, npix=N_LINE, orders=2, device=dev))
    tf_first, tf_warm, T = entry_times(
        lambda: transfer_function(ta, ti, edges, npix=N_TRANSFER, device=dev))
    check(prof.device.type == "cuda" and T.device.type == "cuda"
          and line_profile(a, incl, npix=16)[1].device.type == "cuda"
          and transfer_function(ta, ti, edges, npix=16).device.type == "cuda",
          "the line products did not run on the card (given no device)")
    # the card against itself: atomic sums in another order each run
    prof2 = line_profile(a, incl, npix=N_LINE, orders=2, device=dev)[1]
    T2 = transfer_function(ta, ti, edges, npix=N_TRANSFER, device=dev)
    self_lp = float((prof2 - prof).abs().max() / prof.abs().max())
    self_tf = float((T2 - T).abs().max() / T.abs().max())
    check(max(self_lp, self_tf) <= 1e-13, f"line profile / transfer table "
          f"run to run on the card {self_lp:.3e} / {self_tf:.3e} of the "
          f"peak > 1e-13")
    # tests/test_driver.py's gates, at the full sizes on the card
    g_np, p_np = gc.cpu().numpy(), prof.cpu().numpy()
    nz = p_np > 0
    check(np.isfinite(p_np).all() and p_np.max() > 0
          and g_np[nz].min() < 0.7 and g_np[nz].max() > 1.05,
          "line profile: not broadened both sides of g = 1")
    g2, p2 = (v.cpu().numpy() for v in line_profile(
        a, incl, npix=N_LINE, r_in=10.0, r_out=14.0, device=dev))
    nz2 = p2 > 0.01 * p2.max()
    red = p2[(g2 < 1.0) & nz2].max() if ((g2 < 1.0) & nz2).any() else 0.0
    check(p2[g2 > 1.0].max() > red, "annulus profile: blue horn not above "
          "the red")
    _, _, hit, dA = disk_g_map(ta, ti, N_TRANSFER, None, float(edges[0]),
                               float(edges[-1]), device=dev)
    total = abs(float(T.sum()) - float(hit.sum()) * dA) / (
        float(hit.sum()) * dA)
    check(T.shape == (8, 64) and bool((T >= 0).all()) and total <= 1e-10,
          f"transfer table: T.sum() vs hit.sum() dA {total:.3e} > 1e-10")
    # the card against the CPU at 64^2: each pixel's mask and bins (a
    # pixel that moves bin moves its weight, allowed twice over), then the
    # sums
    n = N_PRODUCT_CMP
    flips, moved_w = 0, 0.0
    for order in (0, 1):
        mk, mc = (disk_g_map(a, incl, n, None, None, None, order, device=d)
                  for d in (dev, "cpu"))
        k, moved = product_flips(
            f"line map order {order}", mk, mc,
            line_map_edges(a, incl, n, None, None, order), 200)
        flips += k
        w = torch.maximum(*(m[0].cpu() ** -3.0 * m[1].cpu() ** 3 * m[3]
                            for m in (mk, mc)))   # emissivity index 3
        moved_w += float(w[moved].sum()) / (1.2 / 200)
    pk = line_profile(a, incl, npix=n, orders=2, device=dev)[1]
    pc, lp_ops = count_ops(lambda: line_profile(a, incl, npix=n, orders=2,
                                                device="cpu"))
    lp_rel = float((pk.cpu() - pc[1]).abs().max() / pc[1].abs().max())
    lp_err = float((pk.cpu() - pc[1]).abs().max()
                   / (1e-12 * pc[1].abs().max() + 2.0 * moved_w))
    mk, mc = (disk_g_map(ta, ti, n, None, float(edges[0]), float(edges[-1]),
                         device=d) for d in (dev, "cpu"))
    k, moved = product_flips(
        "transfer map", mk, mc,
        line_map_edges(ta, ti, n, float(edges[0]), float(edges[-1]), 0,
                       tuple(edges)), 64, torch.from_numpy(edges))
    flips += k
    Tk = transfer_function(ta, ti, edges, npix=n, device=dev)
    Tc, tf_ops = count_ops(lambda: transfer_function(ta, ti, edges, npix=n,
                                                     device="cpu"))
    tf_rel = float((Tk.cpu() - Tc).abs().max() / Tc.abs().max())
    tf_err = float((Tk.cpu() - Tc).abs().max()
                   / (1e-12 * Tc.abs().max() + 2.0 * mc[3] * int(moved.sum())))
    check(max(lp_err, tf_err) <= 1.0, f"line profile / transfer table card "
          f"vs CPU {lp_err:.3f} / {tf_err:.3f} of their bounds (1e-12 of "
          f"the peak, + twice the weight of pixels that moved bin)")
    print(f"phase 18 line profile and transfer function: line_profile "
          f"(a={a}, incl {math.degrees(incl):.0f}, {N_LINE}^2, orders 0-1, "
          f"200 bins) first call {lp_first:.4f} s, warm {lp_warm * 1e3:.3f} "
          f"ms, {launch_text(lp_ops, lp_warm)} | transfer_function (a={ta}, "
          f"incl {math.degrees(ti):.0f}, {N_TRANSFER}^2, 8 x 64) first call "
          f"{tf_first:.4f} s, warm {tf_warm * 1e3:.3f} ms, "
          f"{launch_text(tf_ops, tf_warm)} (min of {ENTRY_RUNS}, host clock, "
          f"synchronised) | run to run on the card (atomic sums): profile "
          f"{self_lp:.3e}, table {self_tf:.3e} of the peak (gate 1e-13) | "
          f"card vs CPU at {n}^2: masks and bins differ on {flips} pixels, "
          f"profile {lp_rel:.3e}, table {tf_rel:.3e} of the peak, "
          f"{lp_err:.3f} / {tf_err:.3f} of their bounds (1e-12 "
          f"of the peak + twice the weight of the pixels that moved) | line broadened over g [{g_np[nz].min():.3f}, "
          f"{g_np[nz].max():.3f}], peak at g {g_np[p_np.argmax()]:.3f}; the "
          f"annulus 10-14 blue horn above the red; T.sum() vs hit.sum() dA "
          f"{total:.3e} (gate 1e-10)", flush=True)
    return dict(lp_first=lp_first, lp_warm=lp_warm, lp_ops=lp_ops,
                tf_first=tf_first, tf_warm=tf_warm, tf_ops=tf_ops)


# tests/test_driver.py's toy slim disk, as example 12 and bench.py's
# thick-disk workload (bench.py:153-259) use it: H = 0.05 R outside r = 6
CONE = dict(a=0.5, incl=math.radians(55.0), rmax=25.0)
N_THICK_IMAGE = 96       # example 12's image
N_THICK = 256            # bench.py's thick-disk frame
THICK_SWEEP = 8          # frames of bench.py's inclination sweep
THICK_RUNS = 3           # host-clock runs of the sweep (the min is kept)
N_THICK_CMP = 64         # the card against the CPU
# example 05 at its full size (examples/05_disk_spectrum.py)
SPEC05 = dict(a=0.7, incl_deg=60.0, radres=0.3, angres=45.0,
              E=np.geomspace(0.1, 50.0, 64))


class Cone:
    """The toy slim disk of tests/test_driver.py, example 12 and bench.py
    on tensors: photosphere at H = 0.05 R, flux r^-3 and T = 1e7 r^-0.75
    outside r = 6, Keplerian rotation at a = 0.5."""
    slope = 0.05

    def r_min(self):
        return 6.0

    def mdot(self):
        return 0.1

    def lumi(self):
        return 0.1

    def flux(self, r):
        return torch.where(r > 6.0, 1.0 / torch.clamp(r, min=1.0) ** 3, 0.0)

    def t_eff(self, r):
        return torch.where(r > 6.0, 1e7 / torch.clamp(r, min=1.0) ** 0.75,
                           0.0)

    def sigma(self, r):
        return torch.ones_like(r)

    def ell(self, r):
        from sim5_tpu_torch.core import ellK
        return ellK(torch.clamp(r, min=6.0), 0.5)

    def vr(self, r):
        return torch.zeros_like(r)

    def h(self, r):
        return self.slope * r

    def dhdr(self, r):
        return torch.full_like(r, self.slope)


def cone_geodesic(alpha, beta, device, dtype=torch.float64, incl=None):
    """Geodesics of the cone's observer (a = 0.5, 55 deg) on `device`."""
    from sim5_tpu_torch import geodesic as gd
    incl = CONE["incl"] if incl is None else incl
    return gd.geodesic_init_inf(
        torch.as_tensor(incl, dtype=dtype, device=device), CONE["a"],
        torch.as_tensor(alpha, dtype=dtype, device=device),
        torch.as_tensor(beta, dtype=dtype, device=device))


def square_grid(npix, rmax):
    """(alpha, beta) of DiskRaytrace.image's npix^2 grid, flattened."""
    xs = ((np.arange(npix) + 0.5) / npix - 0.5) * 2.0 * rmax
    al, be = np.meshgrid(xs, xs)
    return al.ravel(), be.ravel()


def synced(fn):
    """fn()'s result and its time on the synchronised host clock [s]."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def surface_diff(tag, got, want):
    """The largest relative differences of r and m between two surface
    solutions (P, r, m, ok) whose ok masks must be equal."""
    ok = want[3]
    check(torch.equal(got[3].cpu(), ok), f"{tag}: ok masks differ between "
          f"the card and the CPU on {int((got[3].cpu() != ok).sum())} rays")
    return tuple(rel_err(got[i], want[i], ok) for i in (1, 2))


def thick_frame(incl, al, be):
    """bench.py's per-frame body of the thick-disk sweep (bench.py:222-236):
    find_surface, the momentum, the tetrad and the g-factor of every pixel,
    and the frame's total flux."""
    from sim5_tpu_torch.core import photon_momentum
    from sim5_tpu_torch.render import find_surface
    from sim5_tpu_torch.render.driver import disk_tetrad, observed_gfactor
    disk = Cone()
    g = cone_geodesic(al, be, al.device, al.dtype, incl)
    P, r, m, ok = find_surface(g, disk)
    k = photon_momentum(g.a, r, m, g.l, g.q, g.Rpc - P, torch.ones_like(r))
    gf = observed_gfactor(k, disk_tetrad(g.a, r, m, disk))
    ok = ok & torch.isfinite(gf) & (gf > 0.0)
    gf = torch.where(ok, gf, 0.0)
    return torch.where(ok, disk.flux(r * torch.sqrt(1.0 - m * m)) * gf ** 4,
                       0.0).sum()


def thick_sweep(i0, al, be):
    """The THICK_SWEEP frames of bench.py's sweep, one eager call a frame,
    and the sum of their fluxes on the host."""
    incls = i0 + 2e-4 * torch.arange(THICK_SWEEP, dtype=al.dtype,
                                     device=al.device)
    return float(sum(thick_frame(incls[k], al, be)
                     for k in range(THICK_SWEEP)))


def phase_thickdisk(dev):
    """The thick-disk surface solve on the card (the cone at a = 0.5,
    55 deg): the march against the C reference's golden, the root-find on
    the same rays, the card against the CPU, example 12's image and
    bench.py's thick-disk workload in f32."""
    from sim5_tpu_torch.render import (DiskRaytrace, DiskSpectrum_BlackBody,
                                       find_surface, find_surface_march)
    path = pathlib.Path(__file__).resolve().parent / "tests" / "golden"
    al, be, r_ref, m_ref, ok_ref = np.load(
        path / "thickdisk_cone_a05.npy").T
    ok_ref = torch.from_numpy(ok_ref > 0)
    disk = Cone()
    # 1. the march against the reference's __find_surface
    g = cone_geodesic(al, be, dev)
    march, t_march = synced(lambda: find_surface_march(g, disk))
    check(march[1].device.type == "cuda", "the march did not run on the card")
    okm = march[3].cpu()
    check(torch.equal(okm, ok_ref), "march: the hit set differs from the "
          "reference's")
    r_gold = rel_err(march[1], torch.from_numpy(r_ref), ok_ref)
    m_gold = float((march[2].cpu() - torch.from_numpy(m_ref)).abs()[
        ok_ref].max())
    check(r_gold <= 1e-10 and m_gold <= 1e-12, f"march against the golden: "
          f"r {r_gold:.3e} (rtol 1e-10), m {m_gold:.3e} (atol 1e-12)")
    # 2. the root-find on the same rays
    surf, t_surf = synced(lambda: find_surface(g, disk))
    P, r, m, ok = (v.cpu() for v in surf)
    resid = float((r * m - disk.h(r * torch.sqrt(1.0 - m * m))).abs()[
        ok].max())
    agree = float((ok == okm).double().mean())
    both = ok & okm
    dr = float((r - march[1].cpu()).abs()[both].max())
    check(resid < 1e-9 and dr < 0.05 and agree > 0.9, f"find_surface: "
          f"residual {resid:.3e} (gate 1e-9), r vs the march {dr:.3e} (gate "
          f"0.05), hit sets agree on {agree:.3f} (gate 0.9)")
    # 3. the card against the CPU: the root-find on the golden rays and
    # at 64^2, the march on the golden rays
    ga, gb = square_grid(N_THICK_CMP, CONE["rmax"])
    al2, be2 = np.concatenate([al, ga]), np.concatenate([be, gb])
    k_surf = find_surface(cone_geodesic(al2, be2, dev), disk)
    c_surf, surf_ops, c_march, march_ops, frame_ops = cpu_result(
        "cpu thickdisk", cpu_thickdisk)
    errs = surface_diff("find_surface", k_surf, c_surf) + surface_diff(
        "find_surface_march", march, c_march)
    check(max(errs) <= 1e-9, "card vs CPU: find_surface r, m %.3e / %.3e, "
          "the march %.3e / %.3e (gate 1e-9)" % errs)
    # 4. example 12's image, f64
    rt = DiskRaytrace(10.0, CONE["a"], 10.0, disk, DiskSpectrum_BlackBody(),
                      device=dev)
    im, t_img = synced(lambda: rt.image(55.0, CONE["rmax"], N_THICK_IMAGE))
    F, H = im["flux"].cpu(), im["H"].cpu()
    hit12 = float(torch.isfinite(F).double().mean())
    H12 = float(H[torch.isfinite(H)].abs().max())
    check(im["flux"].device.type == "cuda", "example 12's image did not run "
          "on the card")
    check(hit12 > 0.2 and H12 > 0.1,
          f"example 12's image: hit fraction {hit12:.3f} (gate 0.2), max |H| "
          f"{H12:.3f} (gate 0.1)")
    # 5. bench.py's thick-disk workload in f32
    rt32 = DiskRaytrace(10.0, CONE["a"], 10.0, disk,
                        DiskSpectrum_BlackBody(), device=dev,
                        dtype=torch.float32)
    im32, t_img32 = synced(lambda: rt32.image(55.0, CONE["rmax"], N_THICK))
    F, H, R = (im32[k].cpu() for k in ("flux", "H", "R"))
    hit = torch.isfinite(F)
    hit32 = float(hit.double().mean())
    resid32 = float((H[hit] - disk.slope * R[hit]).abs().median())
    check(F.dtype == torch.float32 and hit32 > 0.2 and resid32 < 1e-3,
          f"256^2 f32 image: hit fraction {hit32:.3f} (gate 0.2), median "
          f"residual {resid32:.3e} (gate 1e-3)")
    f32 = dict(dtype=torch.float32, device=dev)
    ga, gb = square_grid(N_THICK, CONE["rmax"])
    al32, be32 = (torch.tensor(v, **f32).reshape(N_THICK, N_THICK)
                  for v in (ga, gb))
    i0 = torch.tensor(CONE["incl"], **f32)
    s0, t_first = synced(lambda: thick_sweep(i0, al32, be32))
    check(math.isfinite(s0) and s0 > 0.0, f"thick sweep: flux sum {s0}")
    ts = [synced(lambda: thick_sweep(i0 + 1e-6 * (i + 1), al32, be32))[1]
          for i in range(THICK_RUNS)]
    dt = min(ts)
    rays_per_sec = THICK_SWEEP * N_THICK * N_THICK / dt
    print(f"phase 19 thick-disk surface solve (the cone H = 0.05 R, a = "
          f"{CONE['a']}, 55 deg): the march on the {len(al)} golden rays "
          f"{t_march:.3f} s, r {r_gold:.3e} relative (gate 1e-10), m "
          f"{m_gold:.3e} (gate 1e-12), hit set equal | find_surface "
          f"{t_surf * 1e3:.1f} ms, residual {resid:.3e} (gate 1e-9), r vs the "
          f"march {dr:.3e} (gate 0.05), hit sets agree on {agree:.3f} | card "
          f"vs CPU (f64; find_surface on those rays and {N_THICK_CMP}^2, the "
          f"march on those rays): ok equal, r, m {errs[0]:.3e} / "
          f"{errs[1]:.3e} and {errs[2]:.3e} / {errs[3]:.3e} relative (gate "
          f"1e-9); CPU counts {surf_ops} ops (find_surface), {march_ops} "
          f"(the march) | example 12's image ({N_THICK_IMAGE}^2, f64) "
          f"{t_img:.3f} s, hit fraction {hit12:.4f}, max |H| {H12:.3f} | "
          f"bench.py's workload (f32): the {N_THICK}^2 image {t_img32:.3f} "
          f"s (first call), hit fraction {hit32:.4f}; {THICK_SWEEP} frames "
          f"one eager call each: first {t_first:.3f} s, min of {THICK_RUNS} "
          f"{dt:.3f} s; a frame {frame_ops} ops (CPU count at "
          f"{N_THICK_CMP}^2), ops x {US_PER_OP} us = "
          f"{frame_ops * US_PER_OP * 1e-6 * THICK_SWEEP / dt:.3f} of the "
          f"time | thickdisk_rays_per_sec={rays_per_sec:.1f} "
          f"thickdisk_resid_median={resid32:.4e}", flush=True)
    return dict(t_march=t_march, t_surf=t_surf, t_img=t_img,
                t_img32=t_img32, sweep_s=dt, frame_ops=frame_ops,
                rays_per_sec=rays_per_sec)


def cpu_thickdisk():
    """Phase 19's CPU side (serialized): find_surface on the golden rays
    and N_THICK_CMP^2, the march on the golden rays, each (None, r, m, ok)
    with its op count, and the op count of a thick f32 frame at
    N_THICK_CMP^2."""
    from sim5_tpu_torch.render import find_surface, find_surface_march
    torch.set_num_threads(1)
    path = pathlib.Path(__file__).resolve().parent / "tests" / "golden"
    al, be = np.load(path / "thickdisk_cone_a05.npy").T[:2]
    ga, gb = square_grid(N_THICK_CMP, CONE["rmax"])
    al2, be2 = np.concatenate([al, ga]), np.concatenate([be, gb])
    disk = Cone()
    surf, surf_ops = count_ops(
        lambda: find_surface(cone_geodesic(al2, be2, "cpu"), disk))
    march, march_ops = count_ops(
        lambda: find_surface_march(cone_geodesic(al, be, "cpu"), disk))
    cpu32 = dict(dtype=torch.float32, device="cpu")
    _, frame_ops = count_ops(lambda: thick_frame(
        torch.tensor(CONE["incl"], **cpu32), torch.tensor(ga, **cpu32),
        torch.tensor(gb, **cpu32)))
    return _dumps(((None, *surf[1:4]), surf_ops, (None, *march[1:4]),
                   march_ops, frame_ops))


def thin_driver(device, dist=10.0, dtype=torch.float64):
    """tests/test_driver.py's thin-disk driver (a = 0.7, M = 10, mdot = 0.1,
    alpha = 0.1) on `device` in `dtype`."""
    from sim5_tpu_torch.disk import ThinDisk
    from sim5_tpu_torch.render import DiskRaytrace, DiskSpectrum_BlackBody
    disk = ThinDisk.create(torch.tensor(10.0, dtype=dtype, device=device),
                           0.7, 0.1, 0.1)
    return DiskRaytrace(10.0, 0.7, dist, disk, DiskSpectrum_BlackBody(),
                        device=device, dtype=dtype)


def phase_driver_spectra(dev):
    """The thin-disk driver and spectra on the card: the reference Python
    layer's goldens, example 05 at its full size, f32 against f64, the
    card against the CPU and the differentiable spectrum."""
    from sim5_tpu_torch.render import make_polar_grid, disk_spectrum
    path = pathlib.Path(__file__).resolve().parent / "tests" / "golden"
    rt = thin_driver(dev)
    # 1. the golden image (tests/test_driver.py's tolerances)
    ref = np.load(path / "driver_image_a07.npy")
    im = rt.image(60.0, 20.0, 32, limbdk=1)
    check(im["flux"].device.type == "cuda", "the image did not run on the "
          "card")
    worst_fp, worst_tol = 1.0, 1.0
    for i, key in enumerate(("flux", "gfactor", "mue", "T", "R", "H", "V")):
        got, want = im[key].cpu().numpy(), ref[i]
        hit_g, hit_w = np.isfinite(got), np.isfinite(want)
        both = hit_g & hit_w
        tol = (dict(rtol=1e-3, atol=1e-3) if key == "mue"
               else dict(rtol=1e-4, atol=1e-12))
        worst_fp = min(worst_fp, float((hit_g == hit_w).mean()))
        worst_tol = min(worst_tol, float(np.isclose(got[both], want[both],
                                                    **tol).mean()))
    check(worst_fp > 0.99 and worst_tol > 0.99, f"golden image: footprint "
          f"{worst_fp:.4f}, within tolerance {worst_tol:.4f} (gates 0.99)")
    # 2. the golden spectra: the odd grid to 3e-2, the even grid's bound
    E, sf_ref, s0_ref = np.load(path / "driver_spectrum_a07_odd.npy")
    sf, s0 = rt.spectrum(60.0, E, limbdk=1, flat=1, radres=2.0, angres=11.0,
                         hardening=1.7)
    nz = sf_ref > 1e-3 * sf_ref.max()
    odd = max(np.abs(sf.numpy()[nz] / sf_ref[nz] - 1.0).max(),
              np.abs(s0.numpy()[nz] / s0_ref[nz] - 1.0).max())
    check(odd < 3e-2, f"odd-grid golden spectrum {odd:.3e} (rtol 3e-2)")
    E, sf_ref, _ = np.load(path / "driver_spectrum_a07.npy")
    sf, _ = rt.spectrum(60.0, E, limbdk=1, flat=1, radres=2.0, angres=10.0,
                        hardening=1.7)
    nz = sf_ref > 1e-3 * sf_ref.max()
    ratio = sf.numpy()[nz] / sf_ref[nz]
    check(ratio.min() >= 1.0 - 3e-2 and ratio.max() <= 1.0 + 2.0 / 14.0
          + 3e-2, f"even-grid golden spectrum: ratio [{ratio.min():.4f}, "
          f"{ratio.max():.4f}] outside [0.97, 1 + 2/14 + 0.03]")
    # 3. example 05 at its full size
    kw05 = dict(radres=SPEC05["radres"], angres=SPEC05["angres"],
                return_diagnostics=True)
    first, warm, (s05, _, diag) = entry_times(
        lambda: rt.spectrum(SPEC05["incl_deg"], SPEC05["E"], **kw05))
    n_rays = make_polar_grid(SPEC05["a"], math.radians(SPEC05["incl_deg"]),
                             SPEC05["radres"], SPEC05["angres"],
                             device="cpu").alpha.numel()
    (c05, _, _), spec_ops = count_ops(lambda: thin_driver("cpu").spectrum(
        SPEC05["incl_deg"], SPEC05["E"], **kw05))
    coverage = diag["domega_err"] / diag["domega_tot"]
    peak = float(c05.max())
    e05 = float((s05 - c05).abs().max()) / peak
    check(bool(torch.isfinite(s05).all()) and peak > 0 and e05 <= 1e-12,
          f"example 05: finite, positive, card vs CPU {e05:.3e} of the peak "
          f"(gate 1e-12)")
    # 4. f32 against f64 (test_driver.py's fast-mode configuration)
    E12 = np.geomspace(0.5, 10.0, 12)
    s64, _ = rt.spectrum(60.0, E12, radres=1.0, angres=20.0)
    s32, _ = thin_driver(dev, dtype=torch.float32).spectrum(
        60.0, E12, radres=1.0, angres=20.0)
    nz = s64 > 1e-6 * s64.max()
    f32_rel = float(((s32 - s64).abs() / s64)[nz].max())
    check(f32_rel < 1e-5, f"f32 spectrum against f64: {f32_rel:.3e} (gate "
          f"1e-5)")
    # 5. the card against the CPU at radres 2, angres 10
    E8 = np.geomspace(0.5, 10.0, 8)
    kw = dict(radres=2.0, angres=10.0, hardening=1.7)
    sk, _ = rt.spectrum(60.0, E8, **kw)
    sc, _ = thin_driver("cpu").spectrum(60.0, E8, **kw)
    cmp_err = float((sk - sc).abs().max() / sc.max())
    check(cmp_err <= 1e-12, f"spectrum card vs CPU {cmp_err:.3e} of the "
          f"peak (gate 1e-12)")
    # 6. the differentiable spectrum on the same quadrature
    E16 = np.geomspace(0.3, 15.0, 16)
    incl = math.radians(60.0)
    grid = make_polar_grid(0.7, incl, radres=2.0, angres=10.0, device=dev)
    fit = disk_spectrum(grid, E16, 10.0, 0.7, 0.1, incl, hardening=1.7)
    check(fit.device.type == "cuda", "disk_spectrum did not run on the card")
    drv, _ = rt.spectrum(60.0, E16, flat=1, radres=2.0, angres=10.0,
                         hardening=1.7)
    nz = drv > 1e-3 * drv.max()
    fit_rel = float(((fit.cpu() - drv).abs() / drv)[nz].max())

    def total(a):
        return torch.log(disk_spectrum(grid, E16, 10.0, a, 0.1, incl,
                                       hardening=1.7).sum())

    a = torch.tensor(0.7, dtype=torch.float64, device=dev,
                     requires_grad=True)
    grad = float(torch.autograd.grad(total(a), a)[0])
    eps = 1e-3
    fd = (float(total(torch.tensor(0.7 + eps, dtype=torch.float64,
                                   device=dev)))
          - float(total(torch.tensor(0.7 - eps, dtype=torch.float64,
                                     device=dev)))) / (2 * eps)
    grad_rel = abs(grad - fd) / abs(fd)
    check(fit_rel < 2e-2 and math.isfinite(grad) and grad_rel < 0.05,
          f"disk_spectrum: against the driver {fit_rel:.3e} (gate 2e-2); "
          f"d log sum / da {grad} against FD {fd} ({grad_rel:.3e}, gate 0.05)")
    print(f"phase 20 thin-disk driver and spectra: golden image (32^2) "
          f"footprint {worst_fp:.4f}, within tolerance {worst_tol:.4f} (gates "
          f"0.99); golden spectra: odd grid {odd:.3e} (rtol 3e-2), even grid "
          f"ratio [{ratio.min():.4f}, {ratio.max():.4f}] | example 05 (a = "
          f"{SPEC05['a']}, {SPEC05['incl_deg']:.0f} deg, radres "
          f"{SPEC05['radres']}, angres {SPEC05['angres']:.0f}, "
          f"{len(SPEC05['E'])} energies 0.1-50 keV): {n_rays} rays, first "
          f"call {first:.4f} s, warm {warm * 1e3:.3f} ms (min of "
          f"{ENTRY_RUNS}, host clock, synchronised), spectrum_rays_per_sec="
          f"{n_rays / warm:.1f}, {launch_text(spec_ops, warm)}; coverage "
          f"error {coverage:.3e} of the solid angle; card vs CPU {e05:.3e} "
          f"of the peak | f32 vs f64 {f32_rel:.3e} (gate 1e-5) | card vs CPU "
          f"at radres 2, angres 10: {cmp_err:.3e} of the peak (gate 1e-12) | "
          f"disk_spectrum vs the driver {fit_rel:.3e} (gate 2e-2), d log "
          f"sum / da {grad:.6f} vs FD {fd:.6f} ({grad_rel:.3e}, gate 0.05)",
          flush=True)
    return dict(first=first, warm=warm, ops=spec_ops, rays=n_rays)


# --- phases 21-22: the derivative layer: the image's gradient through the
# tangent kernel, and the reverse-differentiable march

N_GRAD = 128             # bench.py's per-pixel tangent frame (_jvp_a)
GRAD_H = 1e-4            # its central-difference step
GRAD_RUNS = 3            # host-clock runs of the value-and-grad sweep
N_SCAN_CMP = 96          # the scan engine against the loop engine
SCAN_H = 1e-5
SCAN_SIZE = 256          # its gradient vs FD and timing (512^2 does not fit
                         # at 2048 steps in f64)
# the scan engine runs max_steps // 64 segments, the loop engine up to
# max_steps: example 11's 2000 steps were 2048 (whole segments of 64)
# until phases 23-24 came, then 1024 (the march's first half: the torus
# image holds about half its 2048-step intensity) until phase 27 came;
# at 1024 the whole script took 1316.5 s of its 1200 s on an H100 80GB
# HBM3 (700 W) with a slow host (PERF.md §5), so 512, the first quarter
# (at 32^2 the torus image holds 0.51 of its 1024-step flux)
SCAN_STEPS = 512
# the f32 instance against the f32 plain version (f32_tangent_check,
# f32_backward_check); limits set from the readings in PERF.md
F32_RESOLVED = 1e-4      # a pixel whose plain f32 tangent is this close to
                         # the f64 truth (of its peak) is resolved in f32
F32_UNRESOLVED = 0.005   # at most this share of the footprint unresolved
F32_TAN_GATE = 5e-4      # kernel vs plain on the resolved pixels
F32_BWD_FRAMES = 4       # sweep frames held against the plain backward
F32_BWD_ALL_GATE = 3e-3  # kernel vs plain, relative to the f64 gradient
F32_BWD_GATE = 1e-5      # the same over the resolved pixels


def dual_piece(piece, k=1):
    """The operations of a piece run on duals of k slots (csrc/analytic.cuh's
    Dual<T, K>): + and - 1 + k times, a product 1 + 3k (the flops' mix
    taken as half and half: 1 + 2k times), a quotient k more divisions and
    2k flops, a square root k divisions and a flop, sin or cos both and k
    flops, acos a square root, k divisions and two flops, log1p k divisions
    and 1 + k flops; frexp, ldexp and pow run on values only (the
    quartic's)."""
    flops, ops = piece
    f, new = (1 + 2 * k) * flops, Counter()
    for op, n in ops.items():
        if op == "div":
            new["div"] += (1 + k) * n
            f += 2 * k * n
        elif op == "sqrt":
            new.update(sqrt=n, div=k * n)
            f += n
        elif op in ("sin", "cos"):
            new.update(sin=n, cos=n)
            f += k * n
        elif op == "acos":
            new.update(acos=n, sqrt=n, div=k * n)
            f += 2 * n
        elif op == "log1p":
            new.update(log1p=n, div=k * n)
            f += (1 + k) * n
        else:
            new[op] += n
    return f, dict(new)


def jvp_pixel_pieces(dtype, k=1, reduce=False, c=None):
    """pixel_pieces for the tangent kernel of k slots, c of them (default
    k) through the geodesic and all k through the shading, by the code of
    analytic.cuh: the generic arithmetic on duals (dual_piece), rf by its
    rule (the value chain plus two RD accumulators a level and two RD
    tails, once; two products and a sum a slot), K by dual arithmetic
    through the AGM, sncndn by its rule (the value, two duplication chains
    with one accumulator each, their tails and the epsilon-function
    algebra, once; three pairs of products and a sum a slot), the quartic's
    roots on values plus the implicit rule a root (R'(z) once, the
    numerator and quotient a slot); with `reduce`, the backward's k + 1
    products and k sums a pixel."""
    shade_k, k = k, k if c is None else c
    f64 = dtype == torch.float64
    rf_dup, k_agm, jac = (16, 9, 13) if f64 else (7, 7, 8)
    p = pixel_pieces(dtype)
    rf = _piece(10 * rf_dup + 18, sqrt=3 * rf_dup + 1, div=5)
    K = _piece(3 * k_agm + 2, sqrt=k_agm + 1, div=1)
    rd_tail = _piece(35, sqrt=1, div=4)
    rf_rule = _add(rf, _piece(6 * rf_dup + 1 + 3 * k, div=2 * rf_dup + 2),
                   rd_tail, rd_tail)
    chain1 = _add(rf, _piece(3 * rf_dup, div=rf_dup), rd_tail)
    sncndn = _piece(4 * jac + 9, sqrt=jac + 1, div=4, sin=1, cos=1)
    sn_rule = _add(sncndn, chain1, chain1, _piece(66 + 9 * k, div=10,
                                                  sqrt=1))
    vlog = _piece(1, log1p=1) if f64 else _piece(14, div=3)
    rescale = _piece() if f64 else _piece(9, div=1, frexp=3, ldexp=1)
    real, cplx = _piece(8 + 4 * k, div=k), _piece(23 + 13 * k, div=2 * k)
    roots = {
        "RR": _add(_piece(79, div=20, sqrt=5, pow=1, acos=1, cos=3),
                   _piece(4 * 107, div=8), *[real] * 4,
                   dual_piece(_piece(19, sqrt=2, div=4), k)),
        "RC": _add(_piece(84, div=19, sqrt=4, pow=2),
                   _piece(2 * 107 + 2 * 74, div=4), *[real] * 2,
                   *[cplx] * 2, dual_piece(_piece(40, sqrt=4, div=7), k)),
        "CC": _add(_piece(84, div=19, sqrt=4, pow=2), _piece(4 * 74),
                   *[cplx] * 4, dual_piece(_piece(37, sqrt=4, div=8), k))}
    out = dict(p, **roots)
    out.update(
        pixel=_add(dual_piece(_piece(63, div=10, sqrt=5), k),
                   dual_piece(K, k), rf_rule, rescale,
                   _piece(3 * shade_k + 1 if reduce else 0)),
        rf=rf_rule, K=dual_piece(K, k),
        rad_RR=_add(dual_piece(_piece(30, sqrt=1, div=2), k), sn_rule),
        rad_RC=_add(dual_piece(_piece(45, sqrt=3, div=6), k), sn_rule),
        rad_CC=_add(dual_piece(_piece(38, sqrt=3, div=6), k), sn_rule),
        cross=dual_piece(p["cross"], k),
        shade=_add(dual_piece(_piece(65 + 42 + 3, sqrt=3, div=10), shade_k),
                   *[dual_piece(vlog, shade_k)] * 4))
    return out


def jvp_bound(dtype, counters, lengths, npix, k=1, reduce=False):
    """(bound_ms, bound_by) of the tangent kernel of k slots (the compiled
    instance: all but the last through the geodesic where k > 1) over the
    frames
    whose counters are `counters` (the forward instance's of the same
    frames, `count_disk_image`): its operations (jvp_pixel_pieces) over the
    peak rate of the type, or its bytes over the memory rate (forward mode:
    the two images and their 2k tangents written; the backward: grad_f and
    grad_g read; each frame's six scalars and 6k tangents read)."""
    item = torch.tensor([], dtype=dtype).element_size()
    t = "d" if dtype == torch.float64 else "f"
    pieces = jvp_pixel_pieces(dtype, k, reduce, c=max(k - 1, 1))
    ops = 0
    for piece, n in pixel_mix(counters).items():
        flops, o = pieces[piece]
        ops += n * (flops + sum(c * lengths.get((op, t), 1)
                                for op, c in o.items()))
    pixels = counters["pixels"][1]
    frames = pixels // (npix * npix)
    images = 2 if reduce else 2 + 2 * k
    t_ops = ops / PEAK[dtype]
    t_bytes = (images * pixels + frames * 6 * (1 + k)) * item / H100_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes"), ops


def grad_disk(dtype, dev, spins, incl, dual=None):
    """The headline disk over `spins` with a, incl and mdot leaves that
    require grad, one value a frame: (disk, (a, incl, mdot)).  With `dual`
    (0, 1 or 2; inside a forward-mode dual level) that leaf carries a
    tangent of ones instead."""
    import torch.autograd.forward_ad as fwAD
    from sim5_tpu_torch.disk import nt_setup
    n = len(spins)
    leaves = [torch.tensor(spins, dtype=torch.float64, device=dev).to(dtype),
              torch.full((n,), incl, dtype=dtype, device=dev),
              torch.full((n,), NT["mdot"], dtype=dtype, device=dev)]
    leaves = tuple(fwAD.make_dual(v, torch.ones_like(v)) if k == dual
                   else v.requires_grad_(dual is None)
                   for k, v in enumerate(leaves))
    disk = nt_setup(torch.full((n,), NT["M"], dtype=dtype, device=dev),
                    leaves[0], leaves[2],
                    torch.full((n,), NT["alpha"], dtype=dtype, device=dev))
    return disk, leaves


def spin_tangent(render, dtype, dev, npix, a=NT["a"]):
    """The headline frame's image_f and its tangent in spin by forward mode
    through `render` (bench.py's _jvp_a), and the frames' (n, 6) scalars
    and tangent."""
    import torch.autograd.forward_ad as fwAD
    from sim5_tpu_torch.disk import nt_setup
    from sim5_tpu_torch.render import kernel_image
    with fwAD.dual_level():
        ad = fwAD.make_dual(torch.full((), a, dtype=dtype, device=dev),
                            torch.ones((), dtype=dtype, device=dev))
        disk = nt_setup(*(torch.full((), v, dtype=dtype, device=dev)
                          for v in (NT["M"],)), ad,
                        *(torch.full((), v, dtype=dtype, device=dev)
                          for v in (NT["mdot"], NT["alpha"])))
        fr, fr_t = fwAD.unpack_dual(
            kernel_image.frame_scalars(disk, NT["incl"]).reshape(1, 6))
        f, _ = render(disk, NT["incl"], npix, npix)
        p, t = fwAD.unpack_dual(f)
        return (p.clone(), t.clone(), fr.clone().contiguous(),
                fr_t.clone().contiguous())


def f32_tangent_check(tk, pp, tp, ok, p64, t64):
    """Gate the f32 tangent kernel's per-pixel tangent `tk` against the f32
    plain version's `tp` (values `pp`, common footprint `ok`), reading both
    against the f64 plain tangent `t64` (values `p64`), the truth.

    At a few pixels the f32 chain cannot resolve the tangent at all: where
    the radial quartic's complex pair is nearly real, r's tangent is a
    difference of terms ~1e5 times larger, and in f32 it comes out orders
    of magnitude off the truth in the plain version and the kernel alike,
    each with its own rounding (the card's libm and torch's differ).  So
    the gate holds the pixels where the plain f32 tangent is within
    F32_RESOLVED of the truth's peak (a mask from the plain versions
    alone), at F32_TAN_GATE of that peak, and at most F32_UNRESOLVED of
    the footprint may fall outside.  Returns (max |tk - tp| on the gated
    pixels, a note for the phase line)."""
    ok = ok & ((p64 > 0) == (pp > 0)) & torch.isfinite(t64)
    tk, tp = tk.double(), tp.double()
    peak = float(t64[ok].abs().max())

    def worst(x, mask):
        return float(x[mask].abs().max()) / peak if bool(mask.any()) else 0.0

    resolved = ok & ((tp - t64).abs() <= F32_RESOLVED * peak)
    rest = ok & ~resolved
    share = float(rest.sum()) / float(ok.sum())
    check(share <= F32_UNRESOLVED, f"f32 plain forward mode unresolved on "
          f"{share:.4%} of the footprint > {F32_UNRESOLVED:.2%}")
    rel = worst(tk - tp, resolved)
    check(rel <= F32_TAN_GATE, f"f32 tangent kernel vs plain forward mode "
          f"{rel:.3e} of the f64 peak tangent > {F32_TAN_GATE:g} on the "
          f"resolved pixels")
    return rel * peak, (
        f"{rel:.3e} of the f64 peak tangent on the {int(resolved.sum())} "
        f"pixels where the plain f32 tangent is within {F32_RESOLVED:g} of "
        f"that peak (gate {F32_TAN_GATE:g}); the kernel vs the f64 truth "
        f"there {worst(tk - t64, resolved):.3e}; {int(rest.sum())} pixels "
        f"({share:.4%}) unresolved by the f32 chain, where the kernel and "
        f"the plain version are off the truth by up to "
        f"{worst(tk - t64, rest):.3e} / {worst(tp - t64, rest):.3e} of its "
        f"peak and {worst(tk - tp, rest):.3e} apart")


def f32_backward_check(dev):
    """The f32 backward of F32_BWD_FRAMES frames of the spin sweep at
    512^2 in (a, incl, mdot): the kernel's against the plain f32 version's
    autograd.grad on the same inputs, relative to the f64 plain version's
    gradient at the same (f32-rounded) point, the truth.  Twice: for the
    sweep's loss, imf.sum() * 1e-25, whose f32 gradient carries the
    tangents the f32 chain does not resolve (f32_tangent_check), within
    F32_BWD_ALL_GATE; and for the same sum over the pixels whose tangent
    in each of a, incl and mdot the plain f32 chain resolves, within
    F32_BWD_GATE.  Returns a note for the phase line, the spins, the
    largest |kernel - plain| of the sweep loss's gradient, and the plain
    version's forward and backward of that loss on the synchronised host
    clock (ms)."""
    import torch.autograd.forward_ad as fwAD
    from sim5_tpu_torch.render import render_disk_image
    from sim5_tpu_torch.render.image import render_disk_image_reference
    f32, f64 = torch.float32, torch.float64
    spins = torch.tensor(sweep_spins()[::N_SWEEP // F32_BWD_FRAMES],
                         dtype=f32).double().tolist()
    incl = float(torch.tensor(NT["incl"], dtype=f32))
    # the pixels whose tangent in every column the plain f32 chain resolves
    resolved = True
    for col in range(3):
        tan = {}
        for dt in (f32, f64):
            with fwAD.dual_level():
                disk, leaves = grad_disk(dt, dev, spins, incl, dual=col)
                f, _ = render_disk_image_reference(disk, leaves[1], N_IMAGE,
                                                   N_IMAGE)
                tan[dt] = [v.double().clone() for v in fwAD.unpack_dual(f)]
        (p32, t32), (p64, t64) = tan[f32], tan[f64]
        ok = ((p32 > 0) == (p64 > 0)) & torch.isfinite(t32)
        peak = torch.where(ok, t64.abs(), 0.0).amax((1, 2), keepdim=True)
        resolved = resolved & ok & ((t32 - t64).abs() <= F32_RESOLVED * peak)
    weights = (None, resolved.to(f32))

    def grads(render, dtype):
        disk, leaves = grad_disk(dtype, dev, spins, incl)
        imf, _ = render(disk, leaves[1], N_IMAGE, N_IMAGE)
        out = []
        for w in weights:
            loss = (imf if w is None else imf * w.to(dtype)).sum() * 1e-25
            out.append(torch.stack([v.double() for v in torch.autograd.grad(
                loss, leaves, retain_graph=w is None)]))
        return out

    gk = grads(render_disk_image, f32)
    gp = grads(render_disk_image_reference, f32)
    gt = grads(render_disk_image_reference, f64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    disk, leaves = grad_disk(f32, dev, spins, incl)
    imf, _ = render_disk_image_reference(disk, leaves[1], N_IMAGE, N_IMAGE)
    torch.autograd.grad(imf.sum() * 1e-25, leaves)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    del imf, disk, leaves
    cols, notes = ("a", "incl", "mdot"), []
    for j, (what, gate) in enumerate((("all pixels", F32_BWD_ALL_GATE),
                                      ("resolved pixels", F32_BWD_GATE))):
        k, p, t = gk[j], gp[j], gt[j]
        check(bool(torch.isfinite(k).all()) and bool((t.abs() > 0).all()),
              f"f32 backward ({what}): non-finite or zero gradients")
        kp = ((k - p).abs() / t.abs()).amax(1)
        check(float(kp.max()) <= gate, f"f32 backward vs plain ({what}) "
              f"{float(kp.max()):.3e} of the f64 gradient > {gate:g}")
        notes.append(
            f"{what}: kernel vs plain (gate {gate:g}) " + ", ".join(
                f"{c} {float(v):.3e}" for c, v in zip(cols, kp))
            + "; kernel vs f64 " + ", ".join(
                f"{c} {float(v):.3e}" for c, v in zip(
                    cols, ((k - t).abs() / t.abs()).amax(1)))
            + "; plain f32 vs f64 " + ", ".join(
                f"{c} {float(v):.3e}" for c, v in zip(
                    cols, ((p - t).abs() / t.abs()).amax(1))))
    share = 1.0 - float(resolved.double().mean())
    return (f"f32 backward, {len(spins)} frames of the sweep at {N_IMAGE}^2"
            f", relative to the f64 gradient: " + " | ".join(notes)
            + f" ({share:.4%} of the pixels unresolved in some column)",
            spins, float((gk[0] - gp[0]).abs().max()), plain_ms)


def sweep_columns(frames_cols):
    """The frame columns (of 0-5) that require grad."""
    return [c for c, v in enumerate(frames_cols) if v.requires_grad]


def backward_row(dt, k, ms, plain_ms, bound, err, launches):
    """A kernels-line row of the backward's instance of `dt` with k
    slots."""
    from sim5_tpu_torch.render import kernel_image as ki
    return dict(
        name=(f"{ki.JVP_PROLOGUES[dt, k]} + {ki.VJP_VARIANTS[dt, k]} + "
              f"{ki.REDUCES[dt]}"),
        ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
        max_abs_err=err,
        launches=sum(launches[v] for v in (ki.JVP_PROLOGUES[dt, k],
                                           ki.VJP_VARIANTS[dt, k],
                                           ki.REDUCES[dt])))


def slots_bitwise(dt, dev, fr):
    """The backward's instance of `dt` in forward mode on the frame `fr`
    ((1, 6)), seeded as a backward seeds it (a, incl, rmax through the
    geodesic, rms in the shading's last slot), against one one-slot launch
    a column: (every slot and the images bitwise, K, the K-slot launch's
    ms by CUDA events)."""
    from sim5_tpu_torch.render import kernel_image as ki
    k = ki.JVP_SLOTS[-1]
    cols = (*ki.CHAIN_COLUMNS, ki.RMS_COLUMN)
    tan = torch.zeros((1, 6, k), dtype=dt, device=dev)
    for j, c in enumerate(cols):
        tan[0, c, j] = 1.0
    f, g, df, dg = ki._launch_jvp(fr, tan, N_IMAGE, N_IMAGE)
    same = True
    for j, c in enumerate(cols):
        one = torch.zeros((1, 6), dtype=dt, device=dev)
        one[0, c] = 1.0
        f1, g1, df1, dg1 = ki._launch_jvp(fr, one, N_IMAGE, N_IMAGE)
        same &= all(torch.equal(bits(x), bits(y)) for x, y in (
            (f1, f), (g1, g), (df1, df[:, j]), (dg1, dg[:, j])))
    same &= bool((df.abs().amax((0, 2, 3)) > 0).all())
    ms = event_runs(lambda: ki._launch_jvp(fr, tan, N_IMAGE, N_IMAGE),
                    IMAGE_REPS // 4)
    return same, k, ms


def phase_image_grad(dev, counters, lengths):
    """The image's gradient through the tangent kernel: bench.py's per-pixel
    tangent in spin on the 128^2 f64 frame against the plain version's
    forward mode (1e-8 of the peak tangent on the interior pixels) and
    against central differences of the f64 kernel (pixel_grad_linf_vs_fd <=
    1e-3, interior share > 0.9); the backward in (a, incl, mdot) of a batch
    of three spins at 128^2 in f64 against the plain version's
    autograd.grad (1e-9 relative), one reduction launch for its five
    columns, timed by CUDA events; bench.py's throughput workload,
    value_and_grad of imf.sum() * 1e-25 in (a, incl, mdot) of the 64-frame
    f32 spin sweep at 512^2 (grad_rays_per_sec, the minimum of GRAD_RUNS
    on the synchronised host clock; finite, nonzero, two backward runs
    bitwise equal; one forward launch and one reduction launch whatever
    the column count); the sweep's backward alone by CUDA events, one
    launch of the four-slot instance against five of the one-slot one (the
    design it replaced), with the bound of each; the f32 backward of four
    sweep frames against the plain f32 one (f32_backward_check), timed;
    the four-slot instance's tangents on the headline 512^2 frame, f64 and
    f32, bitwise those of four one-slot launches; each one-slot instance's
    forward mode through the entry point on that frame against the plain
    version's (f64: 1e-8 of the peak tangent; f32: f32_tangent_check),
    timed by CUDA events; the registers, spills and resident blocks of
    every instance.  `counters` are the headline frame's (phase 11)."""
    from sim5_tpu_torch.render import kernel_image, render_disk_image
    from sim5_tpu_torch.render.image import render_disk_image_reference
    ki = kernel_image
    f64, f32 = torch.float64, torch.float32
    L = ki.LAUNCHES
    rows, launches = {}, {}
    # the per-pixel tangent in spin at 128^2, f64, through the entry point
    for k in L:
        L[k] = 0
    _, tk, _, _ = spin_tangent(render_disk_image, f64, dev, N_GRAD)
    torch.cuda.synchronize()
    fwd_path = dict(L)
    check(fwd_path[ki.JVP_VARIANTS[f64, 1]] == 1
          and fwd_path[ki.VARIANTS[f64]] == 1,
          f"forward mode launched {fwd_path}")
    _, tp, _, _ = spin_tangent(render_disk_image_reference, f64, dev, N_GRAD)
    imp = render_disk_image(nt_disk(f64, dev, a=NT["a"] + GRAD_H),
                            NT["incl"], N_GRAD, N_GRAD)[0]
    imm = render_disk_image(nt_disk(f64, dev, a=NT["a"] - GRAD_H),
                            NT["incl"], N_GRAD, N_GRAD)[0]
    fd = (imp - imm) / (2.0 * GRAD_H)
    interior = ((imp > 0) == (imm > 0)) & torch.isfinite(tk)
    share = float(interior.double().mean())
    check(share > 0.9, f"interior share {share:.4f} <= 0.9")
    scale_p = float(tp[interior].abs().max())
    err_plain = float((tk - tp)[interior].abs().max()) / scale_p
    check(err_plain <= 1e-8, f"f64 tangent kernel vs plain forward mode "
          f"{err_plain:.3e} of the peak tangent > 1e-8")
    linf_fd = float((tk - fd)[interior].abs().max()
                    / fd[interior].abs().max())
    check(linf_fd <= 1e-3, f"pixel_grad_linf_vs_fd {linf_fd:.3e} > 1e-3")
    # the backward of a batch of three spins, f64, against the plain one
    for k in L:
        L[k] = 0

    def batch_grads(render):
        disk, leaves = grad_disk(f64, dev, list(BATCH_SPINS), NT["incl"])
        f, g = render(disk, leaves[1], N_BATCH, N_BATCH)
        loss = f.sum() * 1e-25 + g.sum()
        return torch.autograd.grad(loss, leaves), sweep_columns(
            ki.frame_columns(disk, leaves[1]))

    gk, cols64 = batch_grads(render_disk_image)
    torch.cuda.synchronize()
    bwd_path = dict(L)
    k64, seeds64 = ki.backward_launch(cols64)
    check(sum(bwd_path[v] for v in ki.VJP_VARIANTS.values()) == 1
          and bwd_path[ki.REDUCES[f64]] == 1
          and bwd_path[ki.VJP_VARIANTS[f64, k64]] == 1
          and bwd_path[ki.VARIANTS[f64]] == 1,
          f"the f64 backward launched {bwd_path} ({len(cols64)} columns, "
          f"slots {seeds64})")
    t0 = time.perf_counter()
    gp, _ = batch_grads(render_disk_image_reference)
    torch.cuda.synchronize()
    plain_bwd_s = time.perf_counter() - t0
    err_bwd = max(float(((x - y).abs() / y.abs()).max())
                  for x, y in zip(gk, gp))
    check(err_bwd <= 1e-9, f"f64 backward vs plain {err_bwd:.3e} > 1e-9")
    launches[f64] = {k: fwd_path[k] + bwd_path[k] for k in L}
    disk3 = nt_disks(f64, dev, list(BATCH_SPINS))
    frames3 = ki.frame_scalars(disk3, NT["incl"]).contiguous()
    gf3 = torch.full((len(BATCH_SPINS), N_BATCH, N_BATCH), 1e-25,
                     dtype=f64, device=dev)
    gg3 = torch.ones_like(gf3)
    bwd64 = event_runs(lambda: ki._backward(frames3, gf3, gg3, cols64),
                       IMAGE_REPS // 4)
    ki.count_disk_image(disk3, NT["incl"], N_BATCH, N_BATCH)
    bound64, _ = jvp_bound(f64, ki.image_counters(), lengths, N_BATCH, k64,
                           reduce=True)
    rows["f64 backward"] = backward_row(
        f64, k64, bwd64[0], plain_bwd_s * 1e3, bound64,
        max(float((x - y).abs().max()) for x, y in zip(gk, gp)),
        bwd_path)
    # bench.py's throughput workload: the f32 sweep's value and grad
    spins = sweep_spins()

    def grad_sweep():
        disk, leaves = grad_disk(f32, dev, spins, NT["incl"])
        imf, _ = render_disk_image(disk, leaves[1], N_IMAGE, N_IMAGE)
        loss = imf.sum() * 1e-25
        loss.backward()
        return loss.detach(), [v.grad for v in leaves], sweep_columns(
            ki.frame_columns(disk, leaves[1]))

    for k in L:
        L[k] = 0
    v0, g0, cols32 = grad_sweep()
    torch.cuda.synchronize()
    launches[f32] = dict(L)
    k32, seeds32 = ki.backward_launch(cols32)
    check(L[ki.VARIANTS[f32]] == 1
          and sum(L[v] for v in ki.VJP_VARIANTS.values()) == 1
          and L[ki.VJP_VARIANTS[f32, k32]] == 1
          and L[ki.REDUCES[f32]] == 1,
          f"the sweep's value and grad launched {dict(L)} ({len(cols32)} "
          f"columns, slots {seeds32})")
    check(all(bool(torch.isfinite(g).all()) for g in g0)
          and bool(torch.isfinite(v0)), "non-finite gradients")
    check(all(bool((g.abs() > 0).any()) for g in g0), "zero gradients")
    _, g1, _ = grad_sweep()
    check(all(torch.equal(bits(x), bits(y)) for x, y in zip(g0, g1)),
          "two backward runs differ")
    bwd32, spins4, err4, plain4_ms = f32_backward_check(dev)
    runs = []
    for _ in range(GRAD_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, _, _ = grad_sweep()
        float(v)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    runs.sort()
    grad_rays = N_SWEEP * N_IMAGE * N_IMAGE / runs[0]
    # the sweep's backward alone, CUDA events: the launch the path makes,
    # and one one-slot launch (one column), as PR 9 launched a column
    diskN = nt_disks(f32, dev, spins)
    framesN = ki.frame_scalars(diskN, NT["incl"]).contiguous()
    gf = torch.full((N_SWEEP, N_IMAGE, N_IMAGE), 1e-25, dtype=f32,
                    device=dev)
    gg = torch.zeros_like(gf)
    red = event_runs(lambda: ki._backward(framesN, gf, gg, cols32), 2)
    state = card(CARD_STATE)
    red1 = event_runs(lambda: ki._backward(framesN, gf, gg, [0]), 2)
    ki.count_disk_image(diskN, NT["incl"], N_IMAGE, N_IMAGE)
    cN = ki.image_counters()
    (rb, rby), _ = jvp_bound(f32, cN, lengths, N_IMAGE, k32, reduce=True)
    (rb1, _), _ = jvp_bound(f32, cN, lengths, N_IMAGE, 1, reduce=True)
    # the backward of the four frames f32_backward_check held, timed
    disk4 = nt_disks(f32, dev, spins4)
    frames4 = ki.frame_scalars(disk4, NT["incl"]).contiguous()
    bwd4 = event_runs(lambda: ki._backward(frames4, gf[:len(spins4)],
                                           gg[:len(spins4)], cols32),
                      IMAGE_REPS // 4)
    ki.count_disk_image(disk4, NT["incl"], N_IMAGE, N_IMAGE)
    bound4, _ = jvp_bound(f32, ki.image_counters(), lengths, N_IMAGE, k32,
                          reduce=True)
    rows["f32 backward"] = backward_row(f32, k32, bwd4[0], plain4_ms, bound4,
                                        err4, launches[f32])
    # the backward's instance in forward mode on the headline frame: each
    # slot bitwise a one-slot launch
    slot_notes = []
    # each instance's forward mode on the headline 512^2 frame; the f64
    # plain tangent is the truth the f32 instance is read against
    parts, truth = [], None
    for dt in (f64, f32):
        for k in L:
            L[k] = 0
        pk, tk5, fr, fr_t = spin_tangent(render_disk_image, dt, dev, N_IMAGE)
        torch.cuda.synchronize()
        path = dict(L)
        pp, tp5, _, _ = spin_tangent(render_disk_image_reference, dt, dev,
                                     N_IMAGE)
        t0 = time.perf_counter()
        spin_tangent(render_disk_image_reference, dt, dev, N_IMAGE)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        ok = (((pk > 0) == (pp > 0)) & torch.isfinite(tk5)
              & torch.isfinite(tp5))
        if dt == f64:
            diff = float((tk5 - tp5)[ok].abs().max())
            rel = diff / float(tp5[ok].abs().max())
            check(rel <= 1e-8, f"f64 tangent kernel vs plain forward mode at "
                  f"{N_IMAGE}^2 {rel:.3e} of the peak tangent > 1e-8")
            truth = (pp, tp5)
            note = f"{rel:.3e} of the peak tangent, pixels of one footprint"
        else:
            diff, note = f32_tangent_check(tk5, pp, tp5, ok, *truth)
        ms = event_runs(lambda: ki._launch_jvp(fr, fr_t, N_IMAGE, N_IMAGE),
                        IMAGE_REPS)
        (bound_ms, bound_by), ops = jvp_bound(dt, counters[dt], lengths,
                                              N_IMAGE)
        same, kk, kms = slots_bitwise(dt, dev, fr)
        check(same, f"{ki.JVP_VARIANTS[dt, kk]} on the headline frame: a "
              f"slot differs from its one-slot launch")
        (kb, _), _ = jvp_bound(dt, counters[dt], lengths, N_IMAGE, kk)
        slot_notes.append(
            f"{ki.JVP_VARIANTS[dt, kk]}: every slot bitwise its one-slot "
            f"launch; {spread(kms)} ms a launch, bound {kb:.4f} ms "
            f"({kb / kms[0]:.3f})")
        name = f"{ki.JVP_PROLOGUES[dt, 1]} + {ki.JVP_VARIANTS[dt, 1]}"
        rows[f"{dt} forward mode"] = dict(
            name=name, ms=ms[0], plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, max_abs_err=diff,
            launches=path[ki.JVP_PROLOGUES[dt, 1]]
            + path[ki.JVP_VARIANTS[dt, 1]])
        parts.append(
            f"{name}: forward mode, one 512^2 frame {spread(ms)} ms "
            f"(plain forward mode {plain_ms:.3f} ms, host clock); tangent "
            f"vs plain {diff:.3e} ({note}); bound {bound_ms:.4f} ms "
            f"({bound_by}, {ops / N_IMAGE ** 2:.1f} operations a pixel; "
            f"{bound_ms / ms[0]:.3f} of the launch)")
    print(f"phase 21 image gradient: per-pixel tangent in spin "
          f"({N_GRAD}^2, f64, a = {NT['a']}): kernel vs plain forward mode "
          f"{err_plain:.3e} of the peak tangent (gate 1e-8), "
          f"pixel_grad_linf_vs_fd={linf_fd:.4e} (h = {GRAD_H}, interior "
          f"{share:.4f}; gate 1e-3) | backward in (a, incl, mdot), "
          f"{len(BATCH_SPINS)} spins at {N_BATCH}^2, f64: vs plain "
          f"autograd.grad {err_bwd:.3e} relative (gate 1e-9), "
          f"{bwd_path[ki.REDUCES[f64]]} reduction launch for "
          f"{len(cols64)} columns {cols64} (slots {seeds64}), "
          f"{spread(bwd64)} ms "
          f"(CUDA events; bound {bound64[0]:.4f} ms, {bound64[1]}), plain "
          f"backward {plain_bwd_s:.3f} s | value and grad of the "
          f"{N_SWEEP}-frame f32 sweep at {N_IMAGE}^2: {spread(runs)} s (min "
          f"/ median / max of {GRAD_RUNS}, host clock), grad_rays_per_sec="
          f"{grad_rays:.4e}; launches "
          f"{dict((k, v) for k, v in launches[f32].items() if v)} for "
          f"{len(cols32)} columns {cols32} (slots {seeds32}); finite, "
          f"nonzero, two backward runs bitwise equal | the sweep's "
          f"backward alone (CUDA events): {spread(red)} ms, "
          f"{red[0] / N_SWEEP:.4f} ms a frame, bound {rb:.4f} ms ({rby}; "
          f"{rb / red[0]:.3f} of the launch; card after it: {state}); one "
          f"one-slot launch (one "
          f"column) {spread(red1)} ms, bound {rb1:.4f} ms "
          f"({rb1 / red1[0]:.3f}) | {bwd32}; their "
          f"backward {spread(bwd4)} ms (CUDA events), plain forward and "
          f"backward {plain4_ms:.3f} ms (host clock) | "
          + " | ".join(slot_notes) + " | " + " | ".join(parts)
          + f" | instances: {jvp_instances_text()}", flush=True)
    return rows


def fd_scan(points, npix, dev):
    """The scan engine's image of example 11's configuration at npix^2 and
    each ray's trial count, for each (a, radius) of `points`, marched
    together as one batch by the same masked steps (`_transfer_step`, all
    SCAN_STEPS of them, no early exit; elementwise, so each ray's numbers
    are those of its own image): [(I, steps)], no grad."""
    from sim5_tpu_torch.core import r_bh
    from sim5_tpu_torch.march.emission import GaussianSource
    from sim5_tpu_torch.march.raytrace import _TENSOR_FIELDS
    from sim5_tpu_torch.render import lightcurve
    with torch.no_grad():
        seeds = {}
        for a, _ in points:
            if a not in seeds:
                seeds[a] = lightcurve._volume_seed(
                    a, VOL["incl"], 0.0, npix, VOL["rmax"], VOL["r_start"],
                    VOL["precision"], axisymmetric=True, device=dev)
        parts = [seeds[a] for a, _ in points]
        shape = parts[0][1].shape
        def batch(field):
            ts = [getattr(s, field) for s, _ in parts]
            return torch.cat([t.expand(shape) if t.dim() == 0 else t
                              for t in ts], 0)

        st = parts[0][0]._replace(**{f: batch(f) for f in _TENSOR_FIELDS})
        ok = torch.cat([o for _, o in parts], 0)

        def per_ray(vals):
            return torch.cat([torch.full(shape, float(v), dtype=torch.float64,
                                         device=dev) for v in vals], 0)

        r_min = 1.05 * r_bh(per_ray([a for a, _ in points]))
        source = GaussianSource(
            amp=1.0, center=per_ray([c for _, c in points]),
            inv_width=1.0 / 1.5, inv_height=1.0 / 1.5, cylindrical=True)
        tiny = torch.finfo(st.x.dtype).tiny
        I = torch.zeros(ok.shape, dtype=st.x.dtype, device=dev)
        tau, act = torch.zeros_like(I), ok
        for _ in range(SCAN_STEPS):
            st, I, tau, act = lightcurve._transfer_step(
                st, I, tau, act, source, None, r_min, VOL["r_start"] * 1.2,
                tiny)
    n = shape[0]
    return [(I[k * n:(k + 1) * n], st.steps[k * n:(k + 1) * n])
            for k in range(len(points))]


def phase_scan(dev):
    """volume_image(engine="scan") on example 11's torus, f64, SCAN_STEPS
    steps: against the loop engine at N_SCAN_CMP^2 (rtol 1e-12); at
    SCAN_SIZE^2, the largest power-of-two size whose checkpointed segments
    fit on the card (4x the peak printed is past its memory), one forward
    and one backward of d I.sum() / d(a, the torus' radius) timed on the
    synchronised host clock, and the gradient held against central
    differences (h = SCAN_H, rel < 1e-5) on the rays where FD is a
    derivative: their trial count holds within +-h and their central
    differences with h and h / 2 agree to 1e-6.  A termination at another
    step is a jump, and a switch of the step controller (the step floor,
    the epsilon relaxation) within +-h a corner; FD measures those, not
    the derivative, as bench.py's gate excludes the pixels whose hit
    flips.  For a ray with three continuous derivatives the two
    differences differ by about h^2 f^(3) / 8, far below the 1e-6.  Each
    group of rays (kept, trial count changes, FD unconverged) gets its own
    leaf of each parameter, so the one backward gives each group's
    gradient: printed beside the group's FD at h, h / 2 and h / 4 (in a),
    with the all-ray gradient against the all-ray FD.  The FD images march
    as one batch (`fd_scan`)."""
    from sim5_tpu_torch.march.emission import GaussianSource
    from sim5_tpu_torch.render import volume_image

    def image(a, center, npix, engine="scan"):
        return volume_image(
            a, VOL["incl"], GaussianSource(amp=1.0, center=center,
                                           inv_width=1.0 / 1.5,
                                           inv_height=1.0 / 1.5,
                                           cylindrical=True),
            engine=engine, device=dev,
            **dict(volume_kw(VOL, npix), max_steps=SCAN_STEPS))

    p = (VOL["a"], 8.0)

    def leaves():
        return [torch.tensor(float(v), dtype=torch.float64,
                             device=dev).requires_grad_(True) for v in p]

    t0 = time.perf_counter()
    with torch.no_grad():
        I_l = image(VOL["a"], 8.0, N_SCAN_CMP, engine="loop")
        I_s = image(VOL["a"], 8.0, N_SCAN_CMP)
    torch.cuda.synchronize()
    cmp_s = time.perf_counter() - t0
    check(float(I_l.max()) > 0.0, "the loop engine's torus is dark")
    rel = float(((I_s - I_l).abs() / I_l.abs().clamp(min=1e-300)).max())
    check(bool(((I_s - I_l).abs() <= 1e-12 * I_l.abs()).all()),
          f"scan vs loop {rel:.3e} relative > 1e-12")
    # FD at SCAN_SIZE^2: a at h, h / 2 and h / 4, the radius at h and h / 2,
    # in one batch; a ray is kept where its trial count holds at every
    # point and its FD at h and h / 2 agree
    t0 = time.perf_counter()
    hs = {0: (SCAN_H, SCAN_H / 2, SCAN_H / 4), 1: (SCAN_H, SCAN_H / 2)}
    pts = [(p[0] + s * d, p[1]) for d in hs[0] for s in (1, -1)]
    pts += [(p[0], p[1] + s * d) for d in hs[1] for s in (1, -1)]
    runs = fd_scan(pts, SCAN_SIZE, dev)
    fd, held, conv = {}, True, True
    for i in range(2):
        part = runs[:2 * len(hs[0])] if i == 0 else runs[2 * len(hs[0]):]
        fd[i] = []
        for d, (Ip, sp), (Im, sm) in zip(hs[i], part[::2], part[1::2]):
            fd[i].append((Ip - Im) / (2 * d))
            held = held & (sp == sm)
        d1, d2 = fd[i][:2]
        conv = conv & ((d1 - d2).abs() <= 1e-6 * d1.abs()
                       + 1e-9 * float(d1.abs().max()))
    torch.cuda.synchronize()
    fd_s = time.perf_counter() - t0
    groups = {"kept": held & conv, "trial count changes": ~held,
              "FD unconverged": held & ~conv}
    print(f"phase 22 rays whose FD does not converge at {SCAN_SIZE}^2 "
          f"(row-major pixel indices): "
          f"{groups['FD unconverged'].flatten().nonzero().flatten().tolist()}",
          flush=True)
    # one forward and one backward of I.sum(), timed, with a leaf of each
    # parameter for each group of rays (the image is the same bit for bit),
    # so the backward gives each group's share of d I.sum() / d(a, radius)
    torch.cuda.reset_peak_memory_stats(dev)
    x = {k: leaves() for k in groups}

    def per_ray(i):
        out = x["FD unconverged"][i]
        for k in ("trial count changes", "kept"):
            out = torch.where(groups[k], x[k][i], out)
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = image(per_ray(0), per_ray(1), SCAN_SIZE)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat = torch.autograd.grad(img.sum(), [v for k in groups for v in x[k]])
    torch.cuda.synchronize()
    bwd_s = time.perf_counter() - t0
    gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    total = torch.cuda.mem_get_info(dev)[1] / 2 ** 30
    g = {k: [float(v) for v in flat[2 * j:2 * j + 2]]
         for j, k in enumerate(groups)}
    check(all(math.isfinite(v) for k in g for v in g[k]),
          "scan grad not finite")
    errs, text = [], []
    for i in range(2):
        want = float(fd[i][0][groups["kept"]].sum())
        errs.append(abs(g["kept"][i] - want) / max(abs(want), 1e-12))
        check(errs[-1] < 1e-5, f"scan grad arg {i} at {SCAN_SIZE}^2: "
              f"{g['kept'][i]:.6e} vs FD {want:.6e} ({errs[-1]:.3e} > 1e-5)")
        g_all = sum(g[k][i] for k in groups)
        fd_all = float(fd[i][0].sum())
        text.append(
            f"arg {i}: {g['kept'][i]:.9e} vs FD {want:.9e} ({errs[-1]:.3e}; "
            f"gate 1e-5); all rays {g_all:.9e} vs FD {fd_all:.9e} "
            f"({abs(g_all - fd_all) / abs(fd_all):.3e})" + "".join(
                f"; {k} {g[k][i]:.9e} vs FD at h"
                + "".join(f", h/{2 ** n}" for n in range(1, len(hs[i])))
                + " " + ", ".join(f"{float(f[groups[k]].sum()):.9e}"
                                  for f in fd[i])
                for k in list(groups)[1:]))
    print(f"phase 22 scan engine (example 11's torus, f64, "
          f"{SCAN_STEPS} steps in segments of 64): vs loop at "
          f"{N_SCAN_CMP}^2 {rel:.3e} relative (gate 1e-12; both {cmp_s:.2f} "
          f"s) | d I.sum() / d(a, radius) at {SCAN_SIZE}^2 vs FD (h = "
          f"{SCAN_H}; {len(pts)} images {fd_s:.2f} s) on the "
          + ", ".join(f"{int(m.sum())} rays {k}" for k, m in groups.items())
          + ": " + "; ".join(text) + f" | forward {fwd_s:.3f} s, backward "
          f"{bwd_s:.3f} s, peak {gib:.2f} GiB ({2 * SCAN_SIZE}^2 would need ~"
          f"{4 * gib:.1f} GiB of {total:.1f})", flush=True)


def forward_hashes(dev):
    """sha256 of forward results on the card through entry points every
    checkout of the port has: render_disk_image's images (image_f and
    image_g) of the headline frame and the 64-frame spin sweep in f64 and
    f32 (nt_setup, render_disk_image); the march kernel's three family
    variants, raytrace_kernel on the main path's ZAMO rays (every output)
    and volume_image(engine="kernel") on example 11's torus at 128^2, thin
    and thick."""
    from sim5_tpu_torch.march import raytrace_kernel
    from sim5_tpu_torch.render import render_disk_image, volume_image
    out = {}

    def digest(tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()

    for dt in (torch.float64, torch.float32):
        for what, disk in (("frame", nt_disk(dt, dev)),
                           ("sweep", nt_disks(dt, dev, sweep_spins()))):
            out[f"{what} {dt}"] = digest(render_disk_image(
                disk, NT["incl"], N_IMAGE, N_IMAGE))
    st, act = main_path(N_MAIN, torch.float32, dev, raytrace_kernel)
    out["march main path"] = digest(
        [st.x, st.k, st.f, st.kt, st.error, st.steps, act])
    for alpha0 in ALPHA0:
        out[f"torus 128^2 alpha0={alpha0}"] = digest([volume_image(
            VOL["a"], VOL["incl"], torus(), engine="kernel",
            absorption_fn=torus(alpha0), device=dev,
            **volume_kw(VOL, 128))])
    return out


def compare_forward(other):
    """Hash the forward results (forward_hashes) of the checkout at
    `other` and of this one, each in its own process with its tree first
    on sys.path (each builds its own kernels), and compare: 0 if equal."""
    here = pathlib.Path(__file__).resolve().parent
    got = []
    for tree in (pathlib.Path(other).resolve(), here):
        proc = subprocess.run(
            [sys.executable, str(here / "chip_smoke.py"), "--forward-hashes",
             str(tree)], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        got.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"{tree}: {json.dumps(got[-1])}", flush=True)
    same = got[0] == got[1]
    print(f"forward results of the two checkouts: "
          f"{'bitwise equal' if same else 'DIFFERENT'}"
          + ("" if same else ": " + ", ".join(
              k for k in got[1] if got[0].get(k) != got[1][k])), flush=True)
    return 0 if same else 1


def grad_times(dev):
    """The gradient's times through entry points every checkout of the
    port since the derivative layer has (nt_setup, render_disk_image,
    kernel_image._backward and _launch_jvp with an (n, 6) tangent): the
    f32 sweep's value and grad (seconds, the GRAD_RUNS host-clock runs,
    synchronised, sorted), its backward alone (ms, CUDA events, sorted),
    and forward mode in spin on the headline frame, f64 and f32 (ms, CUDA
    events, sorted), with the sha256 of its tangents (image_f's and
    image_g's)."""
    from sim5_tpu_torch.render import kernel_image, render_disk_image
    f32 = torch.float32
    spins = sweep_spins()

    def grad_sweep():
        disk, leaves = grad_disk(f32, dev, spins, NT["incl"])
        imf, _ = render_disk_image(disk, leaves[1], N_IMAGE, N_IMAGE)
        loss = imf.sum() * 1e-25
        loss.backward()
        return loss.detach()

    grad_sweep()
    runs = []
    for _ in range(GRAD_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(grad_sweep())
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    frames = kernel_image.frame_scalars(nt_disks(f32, dev, spins),
                                        NT["incl"]).contiguous()
    gf = torch.full((N_SWEEP, N_IMAGE, N_IMAGE), 1e-25, dtype=f32,
                    device=dev)
    gg = torch.zeros_like(gf)
    # the sweep's columns: a, incl, mdot, rms and the default rmax
    bwd = event_runs(lambda: kernel_image._backward(frames, gf, gg,
                                                    [0, 1, 3, 4, 5]), 2)
    state = card(CARD_STATE)
    fwd, hashes = {}, {}
    for dt in (torch.float64, f32):
        _, _, fr, fr_t = spin_tangent(render_disk_image, dt, dev, N_IMAGE)
        fwd[str(dt)] = event_runs(
            lambda: kernel_image._launch_jvp(fr, fr_t, N_IMAGE, N_IMAGE),
            IMAGE_REPS)
        h = hashlib.sha256()
        for t in kernel_image._launch_jvp(fr, fr_t, N_IMAGE, N_IMAGE)[2:]:
            h.update(t.cpu().numpy().tobytes())
        hashes[str(dt)] = h.hexdigest()
    return dict(value_and_grad_s=sorted(runs), backward_ms=bwd,
                card_after_backward=state, forward_mode_ms=fwd,
                forward_mode_sha256=hashes)


def compare_grad(other):
    """The gradient's times (grad_times) of the checkout at `other` and of
    this one, each in its own process with its tree first on sys.path
    (each builds its own kernels), in turns: other, this, this, other.
    Prints each run and the best of each tree side by side; 0 if every
    run ran."""
    here = pathlib.Path(__file__).resolve().parent
    trees = {"other": pathlib.Path(other).resolve(), "this": here}
    got = {k: [] for k in trees}
    for key in ("other", "this", "this", "other"):
        proc = subprocess.run(
            [sys.executable, str(here / "chip_smoke.py"), "--grad-times",
             str(trees[key])], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        got[key].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"{trees[key]}: {json.dumps(got[key][-1])}", flush=True)

    def best(key, *path):
        vals = []
        for r in got[key]:
            for p in path:
                r = r[p]
            vals.append(r[0])
        return min(vals)

    lines = []
    for what, path in (("value and grad (s)", ("value_and_grad_s",)),
                       ("backward (ms)", ("backward_ms",)),
                       ("forward mode f64 (ms)",
                        ("forward_mode_ms", str(torch.float64))),
                       ("forward mode f32 (ms)",
                        ("forward_mode_ms", str(torch.float32)))):
        a, b = best("other", *path), best("this", *path)
        lines.append(f"{what}: other {a:.6g}, this {b:.6g}, this / other "
                     f"{b / a:.4f}")
    same = all(r["forward_mode_sha256"] == got["other"][0][
        "forward_mode_sha256"] for k in got for r in got[k])
    print(f"gradient times, best of two runs each ({card()}): "
          + " | ".join(lines) + " | forward mode's tangents of the two "
          f"checkouts: {'bitwise equal' if same else 'DIFFERENT'}",
          flush=True)
    return 0


def analytic_times(dev, out_path):
    """The analytic kernels' times through entry points every checkout of
    the port with these kernels has (kernel_analytic.crossing_maps,
    volume_seed_rays; lightcurve.hotspot_lightcurve): the crossing map of
    phase 28 (192^2, orders 0-1) and its five seeds (512^2), CUDA events
    around a call (ms, sorted) and the card's own time a call
    (call_device_ms), and the light curve's entry point (example 07, 192^2, two
    orders, 96 samples; seconds, host clock, synchronised, sorted); the
    outputs saved to out_path (torch.save) for compare_analytic."""
    from sim5_tpu_torch.core import OmegaK
    from sim5_tpu_torch.render import hotspot_lightcurve
    from sim5_tpu_torch.render import kernel_analytic as ka
    a, incl, rs, size = (SPOT[k] for k in ("a", "incl", "r_spot", "size"))
    times, outs = {}, {}

    def crossing():
        return ka.crossing_maps(a, incl, N_HOTSPOT, 2.5 * rs, (0, 1), dev)

    outs["crossing"] = {k: v.cpu() for k, v in crossing().items()}
    times["crossing"] = event_runs(crossing, ANALYTIC_REPS)
    times["crossing, on the card"] = [call_device_ms(crossing)]
    for case, cfg, dt, axi in SEED_CASES:
        key = f"{case} {ka.SEEDS[dt, not axi]}"

        def seed():
            return ka.volume_seed_rays(cfg["a"], cfg["incl"], 0.0, N_VOL_PIX,
                                       cfg["rmax"], cfg["r_start"], axi, dt,
                                       dev)

        outs[key] = [v.cpu() for v in seed()]
        times[key] = event_runs(seed, ANALYTIC_REPS)
        times[f"{key}, on the card"] = [call_device_ms(seed)]
    period = 2.0 * math.pi / float(OmegaK(torch.tensor(rs,
                                                       dtype=torch.float64),
                                          a))
    t_obs = np.arange(HOTSPOT_T) / HOTSPOT_T * 2 * period
    times["hotspot_lightcurve (s)"] = host_runs(lambda: hotspot_lightcurve(
        a, incl, rs, size, t_obs, npix=N_HOTSPOT, n_orders=2, device=dev))
    torch.save(outs, out_path)
    return times


def call_device_ms(fn, tries=4):
    """ms the card spends in fn()'s kernels and copies a call, each
    launched once a call (device_ms_by_kernel, summed; profiled again, up
    to `tries` times, while the trace holds no kernel)."""
    for _ in range(tries):
        ms = device_ms_by_kernel(fn)
        if ms:
            break
    return sum(ms.values())


def compare_analytic(other):
    """The analytic kernels' times (analytic_times) of the checkout at
    `other` and of this one, each in its own process with its tree first
    on sys.path (each builds its own kernels), in turns: other, this, this,
    other.  Prints each run, the best of each tree side by side and the
    largest distance between the two trees' outputs; 0 if every run
    ran."""
    here = pathlib.Path(__file__).resolve().parent
    trees = {"other": pathlib.Path(other).resolve(), "this": here}
    got = {k: [] for k in trees}
    with tempfile.TemporaryDirectory(prefix="sim5_analytic_") as tmp:
        for j, key in enumerate(("other", "this", "this", "other")):
            out = pathlib.Path(tmp) / f"{key}.pt"
            proc = subprocess.run(
                [sys.executable, str(here / "chip_smoke.py"),
                 "--analytic-times", str(trees[key]), str(out)],
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            got[key].append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(f"{trees[key]}: {json.dumps(got[key][-1])}", flush=True)
        outs = {k: torch.load(pathlib.Path(tmp) / f"{k}.pt") for k in trees}
    lines = []
    for what in got["this"][0]:
        a = min(r[what][0] for r in got["other"])
        b = min(r[what][0] for r in got["this"])
        lines.append(f"{what}: other {a:.6g}, this {b:.6g}, this / other "
                     f"{b / a:.4f}")
    dist = []
    for key, o in outs["this"].items():
        p = outs["other"][key]
        xs, ys = (list(o.values()), list(p.values())) if isinstance(o, dict) \
            else (o, p)
        d = max(float((x.double() - y.double()).abs().max())
                for x, y in zip(xs, ys))
        dist.append(f"{key} {d:.3e}")
    print(f"analytic kernels, best of two runs each ({card()}): "
          + " | ".join(lines) + " | largest distance between the two "
          "trees' outputs (every field): " + ", ".join(dist), flush=True)
    return 0


# --tune-analytic: the (threads a block, minimum blocks an SM) pairs each
# pass of the crossing map and of the seed is built at, one pass at a time
# (the other as committed): the second passes, whose chains are long, and
# the first passes
TUNE_ANALYTIC = {1: ((128, 2), (128, 3), (128, 5), (128, 6), (64, 8),
                     (256, 2), (64, 12), (64, 6)),
                 0: ((128, 3), (128, 5), (64, 9), (256, 2))}
TUNE_VARS = {("crossing_map", 0): ("kClassifyThreads", "kClassifyMinBlocks"),
             ("crossing_map", 1): ("kHitThreads", "kHitMinBlocks"),
             ("volume_seed", 0): ("kGeomThreads", "kGeomMinBlocks"),
             ("volume_seed", 1): ("kAzmThreads", "kAzmMinBlocks")}


def tune_analytic_build(key):
    """Build (lib, pass, threads, blocks) of csrc/<lib>.cu with that pass at
    (threads, blocks) (threads None: as committed) into build/; returns
    (key, its ctypes library, seconds, the compiler's report)."""
    from sim5_tpu_torch import _build
    from sim5_tpu_torch.render import kernel_analytic as ka
    name, j, threads, blocks = key
    out = _build.BUILD_DIR / "tune"
    out.mkdir(parents=True, exist_ok=True)
    src_text = (_build.CSRC / f"{name}.cu").read_text()
    if threads is not None:
        var = TUNE_VARS[name, j]
        src_text, n_sub = re.subn(
            rf"constexpr int {var[0]} = \d+, {var[1]} = \d+;",
            f"constexpr int {var[0]} = {threads}, {var[1]} = {blocks};",
            src_text)
        check(n_sub == 1, f"{name}.cu: no {var[0]} line to tune")
    tag = f"{name}_{j}_{threads}_{blocks}"
    src, lib = out / f"{tag}.cu", out / f"lib{tag}.so"
    src.write_text(src_text)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, *ka.NVCC_EXTRA, "-I",
         str(_build.CSRC), "-o", str(lib), str(src)], capture_output=True,
        text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    dll = ctypes.CDLL(str(lib))
    sigs = (ka.CROSSING_SIGNATURES if name == "crossing_map"
            else ka.SEED_SIGNATURES)
    for fn, (argtypes, restype) in sigs.items():
        if fn not in ka.COUNTED_FUNCTIONS:
            f = getattr(dll, fn)
            f.argtypes, f.restype = argtypes, restype
    return key, dll, time.perf_counter() - t0, proc.stdout + proc.stderr


def tune_runs(name, dev):
    """{what: fn} of a tuning build's timed calls, and {what: outputs} to
    hold against the first build's."""
    from sim5_tpu_torch.render import kernel_analytic as ka
    if name == "crossing_map":
        a, incl, rmax = SPOT["a"], SPOT["incl"], 2.5 * SPOT["r_spot"]
        runs = {"map": lambda: ka.crossing_maps(a, incl, N_HOTSPOT, rmax,
                                                (0, 1), dev)}
        return runs, {"map": runs["map"]()}
    cfg = VOL_SPOT
    runs, outs = {}, {}
    for dt in (torch.float64, torch.float32):
        t = "f64" if dt == torch.float64 else "f32"
        for axi in (False, True):
            args = (cfg["a"], cfg["incl"], 0.0, N_VOL_PIX, cfg["rmax"],
                    cfg["r_start"], axi, dt, dev)
            what = f"{t} {'axisymmetric ' if axi else ''}seed"
            runs[what] = lambda args=args: ka.volume_seed_rays(*args)
            outs[what] = runs[what]()
    return runs, outs


def tune_analytic(dev):
    """Time the crossing map (192^2, orders 0-1) and the spot's seeds
    (512^2, f64 and f32, with and without the azimuth), each call by CUDA
    events and each pass on the card by the profiler (pass_device_ms), in
    builds with one pass at each of TUNE_ANALYTIC's pairs and as
    committed, in two rounds (the second in reverse; the minimum kept),
    every build's outputs bitwise the committed build's, with each pass's
    registers, local memory and resident blocks and the compiler's
    spills.  One line a build."""
    from sim5_tpu_torch.render import kernel_analytic as ka
    keys = [(n, j, t, b) for n in ("crossing_map", "volume_seed")
            for j, t, b in ((1, None, None),
                            *((j, t, b) for j in (1, 0)
                              for t, b in TUNE_ANALYTIC[j]))]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        built = list(pool.map(tune_analytic_build, keys))
    print(f"tune: {len(built)} builds in {time.perf_counter() - t0:.1f} s "
          f"({os.cpu_count()} at a time) on {card()}", flush=True)
    ref, res = {}, {}
    for rnd in range(2):
        for key, lib, _, _ in (built if rnd == 0 else built[::-1]):
            ka._LIBS[key[0]] = lib
            runs, outs = tune_runs(key[0], dev)
            for k_out, v in outs.items():
                check(same_bits(tensors_of(ref.setdefault(k_out, v)),
                                tensors_of(v)),
                      f"tune {key}: {k_out} differs from the first build's")
            r = res.setdefault(key, {})
            for what, fn in runs.items():
                ms = {"call": event_runs(fn, ANALYTIC_REPS)[0],
                      **pass_device_ms(fn, ())}
                for k_ms, v in ms.items():
                    w = f"{what}: {k_ms}"
                    r[w] = min(r.get(w, v), v)
    ka._LIBS.clear()
    for key, lib, sec, log in built:
        name, j, threads, blocks = key
        att = []
        for pj in range(2):
            out = (ctypes.c_int * 4)()
            if name == "crossing_map":
                lib.sim5_crossing_map_attributes(pj, out)
                att.append(f"pass {pj} {out[0]}/{out[1]}/{out[2]}x{out[3]}")
            else:
                for f64 in (1, 0):
                    lib.sim5_volume_seed_attributes(f64, 1, pj, out)
                    att.append(f"{'f64' if f64 else 'f32'} pass {pj} "
                               f"{out[0]}/{out[1]}/{out[2]}x{out[3]}")
        shape = ("committed" if threads is None
                 else f"pass {j} at {threads} x {blocks}")
        spills = "; ".join(sorted({ln.strip() for ln in log.splitlines()
                                   if "spill" in ln and "0 bytes spill" not
                                   in ln}))
        print(f"tune {name} {shape} (built in {sec:.1f} s): "
              + ", ".join(f"{w} {v:.4f} ms" for w, v in res[key].items())
              + " | registers/local bytes/blocks x threads an SM: "
              + ", ".join(att) + f" | ptxas spills: {spills or 'none'}",
              flush=True)
    return 0


# --tune-tangent: the (threads a block, minimum blocks an SM) pairs each
# instance of the tangent kernel is timed at, every instance of a build at
# one pair; and other backward instances at the committed pairs, as
# (slots, slots through the geodesic): rms carried through the geodesic
# as a fourth slot, and the four columns in two passes of two
TUNE_SHAPES = ((256, 1), (128, 1), (128, 2), (128, 4), (128, 6), (256, 2),
               (256, 3), (256, 4), (512, 1), (512, 2), (512, 3), (1024, 1))
TUNE_SLOTS = ((None, None, 4, 4), (None, None, 2, 2))


def tune_source(threads, blocks, slots, chain):
    """csrc/disk_image_jvp.cu with every instance at (threads, blocks)
    (None: the committed choices) and the backward at `slots` slots,
    `chain` of them through the geodesic."""
    from sim5_tpu_torch import _build
    src = (_build.CSRC / "disk_image_jvp.cu").read_text()
    for name, v in (("kBackwardSlots", slots), ("kChainSlots", chain)):
        src = re.sub(rf"(constexpr int {name} = )\d+;", rf"\g<1>{v};", src,
                     count=1)
    if threads is not None:
        body = r"(constexpr int {}\(\) \{{\n).*?(\n\}})"
        for fn, v in (("jvp_threads", threads), ("jvp_min_blocks", blocks)):
            src = re.sub(body.format(fn), rf"\g<1>  return {v};\g<2>", src,
                         count=1, flags=re.S)
    return src


def tune_build(key):
    """Build the tangent library of tune_source(*key) into build/; returns
    (key, its ctypes library, seconds)."""
    from sim5_tpu_torch import _build
    from sim5_tpu_torch.render import kernel_image
    out = _build.BUILD_DIR / "tune"
    out.mkdir(parents=True, exist_ok=True)
    name = "jvp_" + "_".join(str(v) for v in key)
    src, lib = out / f"{name}.cu", out / f"lib{name}.so"
    src.write_text(tune_source(*key))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, *kernel_image.NVCC_EXTRA, "-I",
         str(_build.CSRC), "-o", str(lib), str(src)], capture_output=True,
        text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    dll = ctypes.CDLL(str(lib))
    for fn, (argtypes, restype) in kernel_image.JVP_SIGNATURES.items():
        f = getattr(dll, fn)
        f.argtypes, f.restype = argtypes, restype
    return key, dll, time.perf_counter() - t0


def tune_launch(lib, frames, tangent, grad_f=None, grad_g=None):
    """One launch of a tuning build's tangent kernel: forward mode on the
    headline frame (no grads), or the backward."""
    n, k = frames.shape[0], tangent.shape[2]
    dt, dev = frames.dtype, frames.device
    ny = nx = N_IMAGE
    cfg = (ctypes.c_int * 4)()
    check(lib.sim5_nt_image_jvp_config(int(dt == torch.float64), k,
                                       int(grad_f is not None), nx, ny,
                                       cfg) == 0, f"no {k}-slot instance")
    work = torch.empty((n, cfg[3]), dtype=dt, device=dev)
    if grad_f is None:
        bufs = [torch.empty((n, *s, ny, nx), dtype=dt, device=dev)
                for s in ((), (), (k,), (k,))]
        ptrs = [b.data_ptr() for b in bufs] + [None] * 4
    else:
        bufs = [torch.empty((n, cfg[0], k + 1), dtype=dt, device=dev),
                torch.empty((n, k + 1), dtype=dt, device=dev)]
        ptrs = [None] * 4 + [grad_f.data_ptr(), grad_g.data_ptr(),
                             bufs[0].data_ptr(), bufs[1].data_ptr()]
    rc = lib.sim5_nt_image_jvp(
        int(dt == torch.float64), k, frames.data_ptr(), tangent.data_ptr(),
        work.data_ptr(), n, *ptrs, nx, ny, 0, ny, 1.0,
        torch.cuda.current_stream(dev).cuda_stream)
    check(rc == 0, f"tuning launch failed: cudaError {rc}")
    return bufs


def tune_tangent(dev):
    """Time every instance of the tangent kernel at each of TUNE_SHAPES
    and of the committed choices, and the backward at the slot counts of
    TUNE_SLOTS: each build's f32 backward of the 64-frame sweep (its chain
    columns, and one column alone), f64 backward of 8 of its frames, and
    forward mode on the headline frame (f64, f32), by CUDA events, in two
    rounds (the second in reverse; the minimum kept), with each instance's
    registers, local memory and resident blocks.  One line a build."""
    from sim5_tpu_torch.render import kernel_image
    f32, f64 = torch.float32, torch.float64
    keys = [(None, None, 4, 3)] + [(t, b, 4, 3) for t, b in TUNE_SHAPES]
    keys += list(TUNE_SLOTS)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        built = list(pool.map(tune_build, keys))
    print(f"tune: {len(built)} builds in {time.perf_counter() - t0:.1f} s "
          f"({os.cpu_count()} at a time) on {card()}", flush=True)
    spins = sweep_spins()
    frames = {f32: kernel_image.frame_scalars(nt_disks(f32, dev, spins),
                                              NT["incl"]).contiguous(),
              f64: kernel_image.frame_scalars(nt_disks(f64, dev, spins[:8]),
                                              NT["incl"]).contiguous()}
    grads = {dt: (torch.full((fr.shape[0], N_IMAGE, N_IMAGE), 1e-25,
                             dtype=dt, device=dev),
                  torch.ones((fr.shape[0], N_IMAGE, N_IMAGE), dtype=dt,
                             device=dev)) for dt, fr in frames.items()}
    head = {dt: kernel_image.frame_scalars(nt_disk(dt, dev), NT["incl"])
            .reshape(1, 6).contiguous() for dt in (f64, f32)}

    def seed(n, dt, cols, k):
        t = torch.zeros((n, 6, k), dtype=dt, device=dev)
        for j, c in enumerate(cols):
            t[:, c, j] = 1.0
        return t

    seeds = [*kernel_image.CHAIN_COLUMNS, kernel_image.RMS_COLUMN]
    res = {}
    for rnd in range(2):
        for key, lib, _ in (built if rnd == 0 else built[::-1]):
            k = key[2]
            r = res.setdefault(key, {})
            for dt in (f32, f64):
                t = "f32" if dt == f32 else "f64"
                n = frames[dt].shape[0]
                runs = {f"{t} backward": [seed(n, dt, seeds[i:i + k], k)
                                          for i in range(0, len(seeds), k)],
                        f"{t} backward, one column": [seed(n, dt, [0], 1)]}
                for what, tans in runs.items():
                    ms = event_runs(lambda: [tune_launch(
                        lib, frames[dt], tan, *grads[dt]) for tan in tans],
                        2)
                    r[what] = min(r.get(what, ms[0]), ms[0])
                one = seed(1, dt, [0], 1)
                ms = event_runs(lambda: tune_launch(lib, head[dt], one),
                                IMAGE_REPS)
                what = f"{t} forward mode"
                r[what] = min(r.get(what, ms[0]), ms[0])
    for key, lib, sec in built:
        att = []
        for dt in (f64, f32):
            for k in sorted({1, key[2]}):
                for red in (0, 1):
                    a = (ctypes.c_int * 3)()
                    lib.sim5_nt_image_jvp_attributes(int(dt == f64), k, red,
                                                     a)
                    att.append(f"{'f64' if dt == f64 else 'f32'} K={k}"
                               f"{' reduce' if red else ''} {a[0]}/{a[1]}/"
                               f"{a[2]}")
        shape = ("committed" if key[0] is None
                 else f"{key[0]} threads x {key[1]}")
        print(f"tune {shape}, backward in {4 // key[2]} pass(es) of "
              f"{key[2]} slots, {key[3]} through the geodesic (built in "
              f"{sec:.1f} s): "
              + ", ".join(f"{w} {v:.4f} ms" for w, v in res[key].items())
              + " | registers/local bytes/blocks an SM: " + ", ".join(att)
              + f" ({N_SWEEP} f32 frames, 8 f64, at {N_IMAGE}^2)",
              flush=True)
    return 0


# --- phases 23-24: spectral tables, frame checkpoints and host IO (no
# kernel of their own: the table rows are eager torch, the frame stacks
# launch the disk image and march kernels)

# example 08's grid (examples/08_spectral_table.py at its full size)
TABLE = dict(spins=[0.0, 0.5, 0.9], mdots=[0.05, 0.1, 0.3],
             incls=[30.0, 60.0, 75.0], energies=np.geomspace(0.1, 30.0, 64),
             radres=0.5, angres=20.0)
TABLE_CPU_ROWS = (0, 13, 26)   # rows run again on the host's CPU
TABLE_KILL_AT = 5              # rows the killed child reports before its kill
POL_TABLE = dict(spins=[0.0, 0.5, 0.9], incls=[30.0, 60.0, 75.0],
                 energies=POL_E, npix=128)
SAVE_RUNS = 5                  # timed saves (the minimum is kept)
N_STACK = 32                   # frames of the checkpointed spin sweep
STACK_STOP = 12                # frames computed before the interruption
STACK_FLUSH = 4                # frames between two flushes
N_VOL_STACK = 128              # the orbiting spot's checkpointed stack
VOL_STACK = 2                  # frames (cut from 4 for the script's time)
# two chunks one period apart (one image order, cut from 2 for the time)
HOTSPOT_CK = dict(n_t=16, chunk=8, npix=128, n_orders=1)
N_BRIDGE = 48                  # the external disk's image


class Interrupted(Exception):
    """Raised by a frame function to stop a checkpointed stack midway."""


def rows_rel(got, want):
    """Largest relative difference of two tables' rows on the bins above
    1e-6 of each row's peak."""
    worst = 0.0
    for g, w in zip(got, want):
        nz = w > 1e-6 * w.max()
        worst = max(worst, float((np.abs(g[nz] - w[nz]) / w[nz]).max()))
    return worst


def timed_rows(fn):
    """fn()'s result and the seconds between its "[tables] row" lines
    (verbose=True), on the host clock."""
    class Lines:
        def __init__(self):
            self.t = [time.perf_counter()]

        def write(self, s):
            if s.startswith("[tables]"):
                self.t.append(time.perf_counter())

        def flush(self):
            pass

    lines = Lines()
    with contextlib.redirect_stdout(lines):
        out = fn()
    return out, np.diff(lines.t)


def save_times(obj, path_async):
    """(ms of a synchronous save(), ms of save_async's submit, ms until
    the writer has written it), each the minimum of SAVE_RUNS."""
    from sim5_tpu_torch.native import AsyncWriter
    sync, submit, done = [], [], []
    with AsyncWriter() as w:
        for _ in range(SAVE_RUNS):
            t0 = time.perf_counter()
            obj.save()
            sync.append(time.perf_counter() - t0)
            path = obj.path
            obj.path = path_async
            t0 = time.perf_counter()
            obj.save_async(w)
            submit.append(time.perf_counter() - t0)
            w.flush()
            done.append(time.perf_counter() - t0)
            obj.path = path
        check(w.errors == 0, f"the writer reports {w.errors} failed writes")
    return tuple(1e3 * min(v) for v in (sync, submit, done))


TABLE_CHILD = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
from sim5_tpu_torch.tables import generate_disk_table
generate_disk_table(sys.argv[1], verbose=True, energies=np.geomspace(
    0.1, 30.0, 64), **{grid!r})
"""


def killed_table(path):
    """Start generate_disk_table over TABLE in a child process on the
    card, SIGKILL it once it has reported TABLE_KILL_AT rows, and return
    the rows its table holds then."""
    import signal
    from sim5_tpu_torch.tables import SpectralTable
    grid = {k: v for k, v in TABLE.items() if k != "energies"}
    src = TABLE_CHILD.format(root=str(pathlib.Path(__file__).resolve()
                                      .parent), grid=grid)
    proc = subprocess.Popen([sys.executable, "-u", "-c", src, path],
                            stdout=subprocess.PIPE, text=True)
    rows = 0
    try:
        for line in proc.stdout:
            rows += line.startswith("[tables] row")
            if rows >= TABLE_KILL_AT:
                os.kill(proc.pid, signal.SIGKILL)
                break
    finally:
        proc.kill()
        proc.wait(timeout=120)
    check(proc.returncode == -signal.SIGKILL, f"the table's child ended "
          f"with {proc.returncode} before it was killed")
    return SpectralTable.open(path).progress[0]


def phase_tables(dev, tmp):
    """Example 08's grid at its full size through generate_disk_table on
    the card, f64 and fast (f32), rows timed; three f64 rows against the
    same rows on the host's CPU; a child process killed after
    TABLE_KILL_AT rows and resumed, bitwise the uninterrupted table; the
    polarized grid; a table's save() against save_async."""
    from sim5_tpu_torch.march import kernel_march
    from sim5_tpu_torch.render import kernel_image
    from sim5_tpu_torch.tables import (SpectralTable, generate_disk_table,
                                       generate_polarized_table)
    for counts in (kernel_march.LAUNCHES, kernel_image.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))
    n_rows = int(np.prod([len(TABLE[k]) for k in ("spins", "mdots",
                                                  "incls")]))
    t0 = time.perf_counter()
    t64, rows64 = timed_rows(lambda: generate_disk_table(
        os.path.join(tmp, "t64.npz"), device=dev, verbose=True, **TABLE))
    total64 = time.perf_counter() - t0
    t0 = time.perf_counter()
    t32, rows32 = timed_rows(lambda: generate_disk_table(
        os.path.join(tmp, "t32.npz"), device=dev, verbose=True, fast=True,
        **TABLE))
    total32 = time.perf_counter() - t0
    for tag, t in (("f64", t64), ("fast", t32)):
        check(t.progress == (n_rows, n_rows), f"{tag} table: {t.progress}")
        check(bool(np.isfinite(t.spectra).all()
                   and (t.spectra.max(1) > 0).all()),
              f"{tag} table: rows not finite and positive")
    check(t32.meta["fast"] is True and t64.meta["fast"] is False,
          "the tables' meta does not record their mode")
    fast_rel = rows_rel(t32.spectra, t64.spectra)
    check(fast_rel < 1e-5, f"fast rows vs f64 rows {fast_rel:.3e} > 1e-5")
    # three rows again on the host's CPU, as one-row tables
    t0 = time.perf_counter()
    cpu_rel = []
    for idx in TABLE_CPU_ROWS:
        p = t64.row_params(idx)
        one = generate_disk_table(
            os.path.join(tmp, f"cpu{idx}.npz"), [p["spin"]], [p["mdot"]],
            [p["incl"]], TABLE["energies"], radres=TABLE["radres"],
            angres=TABLE["angres"], device="cpu")
        cpu_rel.append(rows_rel(t64.spectra[idx:idx + 1], one.spectra))
    cpu_s = time.perf_counter() - t0
    check(max(cpu_rel) <= 1e-9, f"card rows vs CPU rows {max(cpu_rel):.3e} "
          f"> 1e-9")
    # a child process killed mid-grid, then resumed here
    t0 = time.perf_counter()
    killed_path = os.path.join(tmp, "killed.npz")
    done = killed_table(killed_path)
    child_s = time.perf_counter() - t0
    check(TABLE_KILL_AT <= done < n_rows, f"the killed table holds {done} "
          f"of {n_rows} rows")
    t0 = time.perf_counter()
    resumed, rows_resumed = timed_rows(lambda: generate_disk_table(
        killed_path, device=dev, verbose=True, **TABLE))
    resume_s = time.perf_counter() - t0
    check(len(rows_resumed) == n_rows - done, f"the resume computed "
          f"{len(rows_resumed)} rows, not the {n_rows - done} missing")
    check(np.array_equal(resumed.spectra, t64.spectra), "the resumed table "
          "is not bitwise the uninterrupted one")
    # the polarized grid
    t0 = time.perf_counter()
    pol, pol_rows = timed_rows(lambda: generate_polarized_table(
        os.path.join(tmp, "pol.npz"), device=dev, verbose=True, **POL_TABLE))
    pol_s = time.perf_counter() - t0
    ne = len(POL_TABLE["energies"])
    I, Q, U = (pol.spectra[:, k * ne:(k + 1) * ne] for k in range(3))
    deg = np.hypot(Q, U) / I
    check(pol.progress == (9, 9) and bool(np.isfinite(pol.spectra).all())
          and bool((I > 0).all()) and float(deg.max()) < 0.12,
          f"polarized table: {pol.progress}, degree up to {deg.max():.4f}")
    sync_ms, submit_ms, async_ms = save_times(
        t64, os.path.join(tmp, "t64_async.npz"))
    check(SpectralTable.open(os.path.join(tmp, "t64_async.npz")).progress
          == (n_rows, n_rows), "the asynchronously saved table")
    launches = sum(kernel_march.LAUNCHES.values()) + sum(
        kernel_image.LAUNCHES.values())
    check(launches == 0, f"the tables launched {launches} kernels")
    print(f"phase 23 tables (example 08: {n_rows} rows of "
          f"{len(TABLE['energies'])} energies, radres {TABLE['radres']}, "
          f"angres {TABLE['angres']}; {card()}): f64 grid {total64:.3f} s, a "
          f"row {spread(sorted(rows64 * 1e3))} ms min / median / max (the "
          f"first {rows64[0] * 1e3:.1f} ms; rows include their save) | fast "
          f"grid {total32:.3f} s, a row {spread(sorted(rows32 * 1e3))} ms, "
          f"vs f64 {fast_rel:.3e} relative (gate 1e-5) | rows "
          f"{list(TABLE_CPU_ROWS)} on the host's CPU {cpu_s:.3f} s, vs the "
          f"card " + ", ".join(f"{v:.3e}" for v in cpu_rel) + " relative "
          f"(gate 1e-9) | a child killed after {done} rows ({child_s:.2f} s "
          f"with its start), resumed here ({len(rows_resumed)} rows) in "
          f"{resume_s:.3f} s: bitwise the uninterrupted table | polarized "
          f"grid (3 spins x 3 inclinations, npix {POL_TABLE['npix']}, {ne} energies) "
          f"{pol_s:.3f} s, a row {spread(sorted(pol_rows * 1e3))} ms, "
          f"degree {deg.min():.4f} to {deg.max():.4f} | the table's save() "
          f"{sync_ms:.3f} ms, save_async {submit_ms:.3f} ms to submit, "
          f"{async_ms:.3f} ms until written (min of {SAVE_RUNS}) | kernel "
          f"launches 0 (eager torch)", flush=True)
    return dict(row_ms=float(np.median(rows64)) * 1e3, total64=total64,
                total32=total32, save_ms=sync_ms, async_ms=submit_ms)


def stack(path, fn, n, shape, stop=None, **kw):
    """checkpointed_frames(path, fn, n, shape, **kw), interrupted when fn
    would start frame `stop` (None: never).  Returns (the checkpoint, or
    the frames its file holds after the interruption; the frames this
    call computed)."""
    from sim5_tpu_torch.render import FrameCheckpoint, checkpointed_frames
    computed = []

    def frame(i):
        if i == stop:
            raise Interrupted(i)
        computed.append(i)
        return fn(i)

    try:
        return checkpointed_frames(path, frame, n, shape, **kw), len(computed)
    except Interrupted:
        writer = kw.get("writer")
        if writer is not None:
            writer.flush()
        return FrameCheckpoint.open(path).progress[0], len(computed)


def bridge_twin(dev):
    """tests/data/external_diskmodel.c's model written in torch on `dev`
    (tests/test_torch_external_disk.py's PyTwin)."""
    rin = 6.0 * (1.0 - 0.5 * 0.7)

    class Twin:
        def _r(self, r):
            return torch.as_tensor(r, dtype=torch.float64, device=dev)

        def r_min(self):
            return self._r(rin)

        def mdot(self):
            return self._r(0.1)

        def lumi(self):
            return self._r(0.05)

        def flux(self, r):
            r = self._r(r)
            rs = torch.clamp(r, min=rin * (1 + 1e-12))
            return torch.where(r > rin, 1.0e26 * rs ** -3.0 * (
                1.0 - torch.sqrt(rin / rs)), 0.0)

        def t_eff(self, r):
            from sim5_tpu_torch import consts
            return (torch.clamp(self.flux(r), min=0.0)
                    / consts.sb_sigma) ** 0.25

        def sigma(self, r):
            return 1.0e5 * self._r(r) ** -0.6

        def ell(self, r):
            r = self._r(r)
            return torch.sqrt(r) / (1.0 + 1.0 / r)

        def vr(self, r):
            return torch.zeros_like(self._r(r))

        h = dhdr = vr

    return Twin()


def phase_checkpoints(dev, tmp, native_hash):
    """checkpointed_frames over the spin sweep's first N_STACK frames (f32,
    512^2, through nt_image, flushed through the AsyncWriter every
    STACK_FLUSH frames): uninterrupted, and interrupted after STACK_STOP
    frames and resumed, bitwise each other and the frames of the one
    launch of N_STACK; a VOL_STACK-frame stack of example 07's orbiting
    spot through volume_image(engine="kernel") (t0 a quarter period
    apart, N_VOL_STACK^2), interrupted and resumed; the checkpointed hot
    spot light curve; the external disk bridge's image on the card against
    its torch twin; the native writer built under build/, native/
    untouched."""
    from sim5_tpu_torch import _build
    from sim5_tpu_torch.core import OmegaK
    from sim5_tpu_torch.disk import ExternalDisk
    from sim5_tpu_torch.march import kernel_march
    from sim5_tpu_torch.native import AsyncWriter, native_available
    from sim5_tpu_torch.render import (DiskRaytrace, DiskSpectrum_BlackBody,
                                       hotspot_lightcurve_checkpointed,
                                       kernel_image, render_disk_image,
                                       volume_image)
    check(native_available(), "the native writer did not build or load")
    lib = pathlib.Path(_build.BUILDS["sim5io"]["path"])
    check(lib.parent == _build.BUILD_DIR, f"the native writer is {lib}")
    # the spin sweep as a checkpointed stack of one-frame launches
    spins = sweep_spins()[:N_STACK]
    shape = (N_IMAGE, N_IMAGE)

    def nt_frame(i):
        return render_disk_image(nt_disk(torch.float32, dev, spins[i]),
                                 NT["incl"], N_IMAGE, N_IMAGE)[0]

    kernel_image.LAUNCHES.update(dict.fromkeys(kernel_image.LAUNCHES, 0))
    meta = dict(sweep="spin", a0=spins[0], npix=N_IMAGE)
    with AsyncWriter() as w:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clean, _ = stack(os.path.join(tmp, "nt_clean.npz"), nt_frame,
                         N_STACK, shape, flush_every=STACK_FLUSH, meta=meta,
                         writer=w)
        clean_s = time.perf_counter() - t0
        nt_launches = dict(kernel_image.LAUNCHES)
        path = os.path.join(tmp, "nt_stop.npz")
        done, _ = stack(path, nt_frame, N_STACK, shape, stop=STACK_STOP,
                        flush_every=STACK_FLUSH, meta=meta, writer=w)
        t0 = time.perf_counter()
        resumed, n_resumed = stack(path, nt_frame, N_STACK, shape,
                                   flush_every=STACK_FLUSH, meta=meta,
                                   writer=w)
        resume_s = time.perf_counter() - t0
        bytes_written = w.bytes_written
    for v in ("nt_frames<float>", "nt_image<float>"):
        check(nt_launches[v] == N_STACK, f"the stack launched {v} "
              f"{nt_launches[v]} times, not {N_STACK}")
    check(0 < done <= STACK_STOP and n_resumed == N_STACK - done,
          f"the interrupted stack holds {done} frames, and its resume "
          f"computed {n_resumed}")
    check(np.array_equal(resumed.frames, clean.frames), "the resumed NT "
          "stack is not bitwise the uninterrupted one")
    sweep = render_disk_image(nt_disks(torch.float32, dev, spins),
                              NT["incl"], N_IMAGE, N_IMAGE)[0]
    launch_equal = np.array_equal(sweep.double().cpu().numpy(), clean.frames)
    check(launch_equal, "the stack's frames are not bitwise the frames of "
          f"one launch of {N_STACK}")
    check(float(clean.frames.max()) > 0, "the NT stack is dark")
    sync_ms, submit_ms, async_ms = save_times(
        clean, os.path.join(tmp, "nt_async.npz"))
    # example 07's orbiting spot, one volume image a frame
    period = 2.0 * math.pi / float(OmegaK(torch.tensor(
        SPOT["r_spot"], dtype=torch.float64), SPOT["a"]))

    def vol_frame(i):
        return volume_image(VOL_SPOT["a"], VOL_SPOT["incl"], spot(),
                            engine="kernel", t0=0.25 * period * i, device=dev,
                            **volume_kw(VOL_SPOT, N_VOL_STACK))

    kernel_march.LAUNCHES.update(dict.fromkeys(kernel_march.LAUNCHES, 0))
    reset_analytic()
    vshape = (N_VOL_STACK, N_VOL_STACK)
    t0 = time.perf_counter()
    vclean, _ = stack(os.path.join(tmp, "vol_clean.npz"), vol_frame,
                      VOL_STACK, vshape)
    vol_s = time.perf_counter() - t0
    vol_launches = {**kernel_march.LAUNCHES, **analytic_launches()}
    seed_v = seed_name(VOL_SPOT)
    check(vol_launches[seed_v] == VOL_STACK, f"the volume stack launched "
          f"{seed_v} {vol_launches[seed_v]} times, not {VOL_STACK}")
    vpath = os.path.join(tmp, "vol_stop.npz")
    vdone, _ = stack(vpath, vol_frame, VOL_STACK, vshape,
                     stop=VOL_STACK // 2)
    vres, v_resumed = stack(vpath, vol_frame, VOL_STACK, vshape)
    variant = kernel_march.VARIANTS[1]
    check(vol_launches[variant] >= VOL_STACK, f"the volume stack launched "
          f"{variant} {vol_launches[variant]} times")
    check(vdone == VOL_STACK // 2 and v_resumed == VOL_STACK - vdone,
          f"the interrupted volume stack holds {vdone} frames, and its "
          f"resume computed {v_resumed}")
    check(np.array_equal(vres.frames, vclean.frames), "the resumed volume "
          "stack is not bitwise the uninterrupted one")
    check(bool((vclean.frames.reshape(VOL_STACK, -1).max(1) > 0).all()),
          "a dark volume frame")
    # the checkpointed hot spot light curve: two chunks, one period apart
    hc = HOTSPOT_CK
    t_obs = np.arange(hc["n_t"]) / hc["n_t"] * 2 * period
    reset_analytic()
    t0 = time.perf_counter()
    _, lc = hotspot_lightcurve_checkpointed(
        os.path.join(tmp, "lc.npz"), SPOT["a"], SPOT["incl"], SPOT["r_spot"],
        SPOT["size"], t_obs, npix=hc["npix"], n_orders=hc["n_orders"],
        chunk=hc["chunk"], device=dev)
    lc_s = time.perf_counter() - t0
    lc_launches = analytic_launches()
    check(lc_launches["crossing_map<double>"] == hc["n_t"] // hc["chunk"],
          f"the checkpointed light curve launched {launched(lc_launches)}")
    half = hc["n_t"] // 2
    per_rel = float(np.abs(lc[half:] - lc[:half]).max() / lc[:half].min())
    check(bool(np.isfinite(lc).all() and (lc > 0).all()) and per_rel <= 1e-9,
          f"checkpointed light curve: one period apart {per_rel:.3e} > 1e-9")
    # the external disk bridge on the card against its torch twin
    cc = shutil.which("cc") or shutil.which("gcc")
    check(cc is not None, "no C compiler for the external disk model")
    so = _build.BUILD_DIR / "external_diskmodel.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([cc, "-shared", "-fPIC", "-O2", "-o", str(so),
                    str(pathlib.Path(__file__).resolve().parent / "tests" /
                        "data" / "external_diskmodel.c"), "-lm"], check=True)
    t0 = time.perf_counter()
    disk = ExternalDisk.create(str(so), 10.0, 0.7, device=dev)
    bridge_s = time.perf_counter() - t0
    images = [DiskRaytrace(10.0, 0.7, 10.0, d, DiskSpectrum_BlackBody(),
                           device=dev).image(60.0, 20.0, N_BRIDGE)["flux"]
              for d in (disk, bridge_twin(dev))]
    hit = torch.isfinite(images[0])
    check(images[0].device == disk.rmin_.device == dev,
          "the bridge image did not run on the card")
    check(bool((hit == torch.isfinite(images[1])).all())
          and int(hit.sum()) > 100,
          "the bridge image's footprint is not its twin's")
    b_rel = float(((images[0] - images[1]).abs() / images[1].abs())[hit]
                  .max())
    check(b_rel <= 1e-5, f"bridge image vs twin {b_rel:.3e} > 1e-5")
    check(_native_hash() == native_hash, "native/ changed")
    print(f"phase 24 checkpoints and IO ({card()}): spin sweep of {N_STACK} "
          f"f32 frames at {N_IMAGE}^2 through checkpointed_frames (flushed "
          f"every {STACK_FLUSH} through the native AsyncWriter) in "
          f"{clean_s:.3f} s, LAUNCHES={launched(nt_launches)}; interrupted "
          f"at frame "
          f"{STACK_STOP} with {done} on disk, resumed ({n_resumed} frames) "
          f"in {resume_s:.3f} s: "
          f"bitwise the uninterrupted stack and the one launch of "
          f"{N_STACK} | the stack's save() {sync_ms:.3f} ms, save_async "
          f"{submit_ms:.3f} ms to submit, {async_ms:.3f} ms until written "
          f"({clean.frames.nbytes / 2 ** 20:.0f} MiB; min of {SAVE_RUNS}; "
          f"{bytes_written / 2 ** 20:.0f} MiB written by the writer) | "
          f"orbiting spot, {VOL_STACK} frames at {N_VOL_STACK}^2 through "
          f"volume_image(engine=\"kernel\") in {vol_s:.3f} s, "
          f"LAUNCHES={launched(vol_launches)}; interrupted with {vdone} done, "
          f"resumed ({v_resumed} frames) bitwise | "
          f"hotspot_lightcurve_checkpointed ({hc['n_t']} times in chunks "
          f"of {hc['chunk']}, {hc['npix']}^2, {hc['n_orders']} orders) "
          f"{lc_s:.3f} s, LAUNCHES={launched(lc_launches)}, chunks one "
          f"period apart "
          f"within {per_rel:.3e} (gate 1e-9) | external disk bridge: "
          f"tables {bridge_s:.3f} s, {N_BRIDGE}^2 image vs its twin "
          f"{b_rel:.3e} (gate 1e-5), footprints equal | native writer "
          f"{lib.name}, native/ unchanged", flush=True)
    return dict(stack_s=clean_s, vol_s=vol_s, lc_s=lc_s, save_ms=sync_ms,
                async_ms=submit_ms)


# the parallel layer on one card (phase 25)
WINDOW_SPLITS = (1, 3, 7)      # the headline frame cut as meshes of 1, 3 and
                               # 7 ranks would cut it (3 and 7 divide no 512)
FIT_STEPS = 5
FIT_START = dict(M=10.1, a=0.995, mdot=0.105, incl=math.radians(79.0))
FIT_LR = 5e-4
N_FIT_GRAD = 128               # step 1's gradient against the plain version
# the examples on the card (phase 26): (file, arguments before the device,
# full size); the others run at SIM5_FAST, their full-size paths being
# phases 15-17, 23, 24 and 27 (example 11's sweep at its 64^2)
EXAMPLES = (
    ("torch_01_kerr_spacetime.py", (), True),
    ("torch_04_disk_image.py", ("0.0", "60", "512"), True),
    ("torch_05_disk_spectrum.py", ("0.7", "60"), True),
    ("torch_06_polarization_map.py", ("0.9", "70", "32"), False),
    ("torch_07_hotspot_lightcurve.py", ("0.5", "70", "7"), False),
    ("torch_08_spectral_table.py", ("tab.npz",), False),
    ("torch_09_black_hole_shadow.py", ("0.9", "70", "32"), False),
    ("torch_10_polarized_spectrum.py", ("0.9", "70"), False),
    ("torch_11_thick_volume_transfer.py", ("0.9", "70"), False),
    ("torch_12_checkpointed_survey.py", ("0.7", "60"), False),
)
NUMBER = re.compile(r"[-+]?\d+\.\d+e?[-+]?\d*")


def window_split(n, k):
    """[(row0, rows)] of an n-row frame cut as a mesh of k ranks cuts it
    (parallel.mesh: blocks of ceil(n / k) rows, the last shorter)."""
    block = -(-n // k)
    return [(r0, min(block, n - r0)) for r0 in range(0, n, block)]


def window_grads(dev, dtype, windows):
    """The headline frame in the given row windows: the concatenated
    images, and d/d(a, incl, M, mdot) of the sum over the windows of
    image_f 1e-25 + image_g, one backward per window."""
    from sim5_tpu_torch.disk import nt_setup
    from sim5_tpu_torch.render import render_disk_image
    leaves = [torch.tensor(v, dtype=dtype, device=dev, requires_grad=True)
              for v in (NT["a"], NT["incl"], NT["M"], NT["mdot"])]
    disk = nt_setup(leaves[2], leaves[0], leaves[3],
                    torch.tensor(NT["alpha"], dtype=dtype, device=dev))
    fs, gs, grads = [], [], None
    for r0, rows in windows:
        f, g = render_disk_image(disk, leaves[1], N_IMAGE, N_IMAGE, None,
                                 r0, rows)
        part = torch.autograd.grad((f * 1e-25).sum() + g.sum(), leaves,
                                   retain_graph=True)
        grads = part if grads is None else [x + y for x, y in zip(grads,
                                                                   part)]
        fs.append(f.detach())
        gs.append(g.detach())
    return torch.cat(fs), torch.cat(gs), torch.stack(grads).double()


def phase_parallel(dev):
    """The parallel layer on one card: make_mesh() as a one-rank NCCL
    group; the headline frame (512^2, f64 and f32) rendered in the row
    windows that meshes of 1, 3 and 7 ranks would give their ranks,
    bitwise the one-launch frame, and the backward in (a, incl, M, mdot)
    summed over the windows against the whole frame's (1e-12 relative in
    f64, 1e-5 of the f64 gradient in f32); render_disk_image_sharded
    bitwise render_disk_image; fit_step_sharded at 512^2 in f64 for
    FIT_STEPS Adam steps from FIT_START toward the headline frame (the
    loss falls; each step timed on the synchronised host clock, its kernel
    launches and collectives counted: 2 forward, 3 backward, 1
    all-reduce), step 1's gradient at 128^2 against the plain version's
    autograd.grad on the card (1e-9 relative); DiskRaytrace.image(mesh=)
    at example 12's size and .spectrum(mesh=) at example 05's, and a
    generate_disk_table(mesh=) row, each bitwise its unsharded call.  The
    group is destroyed at the end."""
    import torch.distributed as dist
    from sim5_tpu_torch.core import r_ms
    from sim5_tpu_torch.disk import nt_setup
    from sim5_tpu_torch.parallel import (fit_step_sharded,
                                         loss_and_grad_sharded, make_mesh,
                                         render_disk_image_sharded)
    from sim5_tpu_torch.parallel import mesh as pmesh
    from sim5_tpu_torch.render import (DiskRaytrace, DiskSpectrum_BlackBody,
                                       kernel_image, render_disk_image)
    from sim5_tpu_torch.render.image import render_disk_image_reference
    from sim5_tpu_torch.tables import generate_disk_table
    f64, f32 = torch.float64, torch.float32
    t_phase = time.perf_counter()
    mesh = make_mesh()
    check(dist.get_backend(mesh.get_group()) == "nccl" and mesh.size() == 1,
          f"make_mesh(): {dist.get_backend(mesh.get_group())} group of "
          f"{mesh.size()}")
    parts = [f"make_mesh(): one-rank {dist.get_backend(mesh.get_group())} "
             f"DeviceMesh {mesh.mesh_dim_names}"]
    # 1. row windows of the headline frame
    truth = None
    for dt in (f64, f32):
        f1, g1, grad1 = window_grads(dev, dt, window_split(N_IMAGE, 1))
        if dt == f64:
            truth = grad1
        errs = []
        for k in WINDOW_SPLITS[1:]:
            w = window_split(N_IMAGE, k)
            fk, gk, gradk = window_grads(dev, dt, w)
            check(torch.equal(bits(fk), bits(f1))
                  and torch.equal(bits(gk), bits(g1)),
                  f"{dt} frame in {len(w)} windows differs from one launch")
            err = float(((gradk - grad1).abs() / truth.abs()).max())
            errs.append(err)
            gate = 1e-12 if dt == f64 else 1e-5
            check(err <= gate, f"{dt} backward summed over {len(w)} windows "
                  f"vs the whole frame's: {err:.3e} > {gate}")
        parts.append(f"{dt} headline frame in windows of "
                     f"{[window_split(N_IMAGE, k)[0][1] for k in WINDOW_SPLITS]}"
                     f" rows: bitwise one launch; backward over the windows "
                     f"vs the whole frame's {max(errs):.3e} (of the f64 "
                     f"gradient)")
    # 2. the sharded render against the entry point
    rmax = float(r_ms(torch.tensor(NT["a"], dtype=f64))) + 8.0
    fs, gs = render_disk_image_sharded(mesh, NT["M"], NT["a"], NT["mdot"],
                                       NT["alpha"], NT["incl"], N_IMAGE,
                                       N_IMAGE, rmax=rmax)
    fu, gu = render_disk_image(nt_disk(f64, dev), NT["incl"], N_IMAGE,
                               N_IMAGE, rmax)
    check(torch.equal(bits(fs), bits(fu)) and torch.equal(bits(gs), bits(gu)),
          "render_disk_image_sharded differs from render_disk_image")
    parts.append("render_disk_image_sharded bitwise render_disk_image")
    # 3. the fit at 512^2, f64
    target = fu
    p0 = torch.tensor([FIT_START[k] for k in ("M", "a", "mdot", "incl")],
                      dtype=f64, device=dev)
    # step 1's loss and gradient at N_FIT_GRAD^2 against the plain version
    t128 = render_disk_image(nt_disk(f64, dev), NT["incl"], N_FIT_GRAD,
                             N_FIT_GRAD, rmax)[0]
    lg, gk = loss_and_grad_sharded(mesh, p0, t128, None, N_FIT_GRAD,
                                   N_FIT_GRAD, rmax)
    leaf = p0.clone().requires_grad_(True)
    disk = nt_setup(leaf[0], leaf[1], leaf[2], 0.1)
    imp, _ = render_disk_image_reference(disk, leaf[3], N_FIT_GRAD,
                                         N_FIT_GRAD, rmax)
    loss_p = (((imp - t128) ** 2).mean()
              / torch.clamp((t128 ** 2).mean(), min=1e-300))
    (gp,) = torch.autograd.grad(loss_p, leaf)
    loss_p = loss_p.detach()
    gerr = float(((gk - gp).abs() / gp.abs()).max())
    check(gerr <= 1e-9, f"fit gradient at {N_FIT_GRAD}^2 vs the plain "
          f"version's autograd.grad: {gerr:.3e} > 1e-9")
    check(abs(float(lg) - float(loss_p)) <= 1e-9 * abs(float(loss_p)),
          f"fit loss {float(lg):.9e} vs plain {float(loss_p):.9e}")
    L = kernel_image.LAUNCHES
    C = pmesh.COLLECTIVES
    fit_path = ([kernel_image.PROLOGUES[f64], kernel_image.VARIANTS[f64]],
                [kernel_image.JVP_PROLOGUES[f64, 4],
                 kernel_image.VJP_VARIANTS[f64, 4], kernel_image.REDUCES[f64]])
    # torch.optim's first step in a process imports its compiler hooks
    # (seconds): taken once on a scratch tensor, timed apart
    scratch = torch.zeros(4, dtype=f64, device=dev, requires_grad=True)
    scratch.grad = torch.ones_like(scratch)
    t0 = time.perf_counter()
    torch.optim.Adam([scratch], lr=FIT_LR).step()
    torch.cuda.synchronize()
    optim_first_s = time.perf_counter() - t0
    p, st, losses, step_s = p0, None, [], []
    for i in range(FIT_STEPS):
        for c in (L, C):
            for key in c:
                c[key] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, loss, st = fit_step_sharded(mesh, p, target, None, N_IMAGE,
                                       N_IMAGE, lr=FIT_LR, opt_state=st,
                                       rmax=rmax)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
        got = {key: v for key, v in L.items() if v}
        want = dict.fromkeys(fit_path[0] + fit_path[1], 1)
        check(got == want and C == {"all_reduce": 1, "all_gather": 0},
              f"fit step {i + 1} launched {got} and {C}")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"the fit's loss did not fall: {losses}")
    prof = fit_profile(mesh, p, target, st)
    check(st[1] == rmax, f"the fit's grid moved: rmax {st[1]} vs {rmax}")
    parts.append(
        f"fit_step_sharded at {N_IMAGE}^2, f64, (M, a, mdot, incl) from "
        f"{tuple(FIT_START.values())}: loss {' -> '.join(f'{v:.6e}' for v in losses)}; "
        f"step {' / '.join(f'{1e3 * v:.3f}' for v in step_s)} ms (host "
        f"clock, synchronised; torch.optim's first step in the process "
        f"{optim_first_s:.3f} s before them); launches a step: "
        f"{len(fit_path[0])} forward "
        f"{fit_path[0]}, {len(fit_path[1])} backward {fit_path[1]}, "
        f"1 all_reduce; one more step under torch.profiler: {prof} | "
        f"step 1's gradient at {N_FIT_GRAD}^2 vs plain "
        f"autograd.grad {gerr:.3e} (gate 1e-9); params after "
        f"{FIT_STEPS} steps {[round(float(v), 9) for v in p]}")
    # 4. DiskRaytrace with mesh=, and a table row
    cone = DiskRaytrace(10.0, CONE["a"], 10.0, Cone(),
                        DiskSpectrum_BlackBody(), device=dev)
    (im_u, im_s), t_im = synced(lambda: (
        cone.image(55.0, CONE["rmax"], N_THICK_IMAGE),
        cone.image(55.0, CONE["rmax"], N_THICK_IMAGE, mesh=mesh)))
    for key in im_u:
        check(torch.equal(bits(im_u[key]), bits(im_s[key])),
              f"DiskRaytrace.image(mesh=) {key} differs from unsharded")
    rt = thin_driver(dev)
    kw05 = dict(radres=SPEC05["radres"], angres=SPEC05["angres"],
                return_diagnostics=True)
    (s_u, s_s), t_sp = synced(lambda: (
        rt.spectrum(SPEC05["incl_deg"], SPEC05["E"], **kw05),
        rt.spectrum(SPEC05["incl_deg"], SPEC05["E"], mesh=mesh, **kw05)))
    check(all(torch.equal(bits(x), bits(y)) for x, y in zip(s_u[:2], s_s[:2]))
          and s_u[2] == s_s[2],
          "DiskRaytrace.spectrum(mesh=) differs from unsharded")
    with tempfile.TemporaryDirectory(prefix="sim5_mesh_") as tmp:
        kw = dict(spins=[0.5], mdots=[0.1], incls=[60.0],
                  energies=np.geomspace(0.1, 30.0, 64), radres=0.5,
                  angres=20.0, device=dev)
        t_u = generate_disk_table(os.path.join(tmp, "u.npz"), **kw)
        t_s = generate_disk_table(os.path.join(tmp, "s.npz"), mesh=mesh,
                                  **kw)
        check(np.array_equal(t_u.spectra, t_s.spectra)
              and np.isfinite(t_s.spectra).all(),
              "generate_disk_table(mesh=) row differs from unsharded")
    parts.append(
        f"DiskRaytrace.image(mesh=) on the cone at {N_THICK_IMAGE}^2 and "
        f".spectrum(mesh=) at example 05's size, each bitwise unsharded "
        f"({t_im:.3f} s and {t_sp:.3f} s for both calls); a "
        f"generate_disk_table(mesh=) row (example 08's radres 0.5, angres "
        f"20, 64 energies) bitwise the row without a mesh")
    dist.destroy_process_group()
    print(f"phase 25 parallel layer ({time.perf_counter() - t_phase:.1f} s): "
          + " | ".join(parts), flush=True)
    return dict(losses=losses, step_s=step_s, grad_err=gerr)


def fit_profile(mesh, p, target, st):
    """Two more fit steps (their results dropped), each under its own
    torch.profiler, the first a warm-up, the second split by the step's
    record_function stages (`mesh.FIT_STAGES`): each stage's host time
    and the CUDA launches (cudaLaunch* / cuLaunch* calls) and copies
    (cudaMemcpy* / cudaMemset*) that start inside it, on any thread (the
    backward's run on autograd's device thread), the rest under "other";
    the ops that made the most launches; the device time of the image
    kernels and of every kernel; the recorded step's wall time
    (synchronised); and the host's cost, with no profiler running, of an
    empty record_function range and of the fit's stage (`mesh._stage`,
    which then opens none).  As text."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from sim5_tpu_torch.parallel import fit_step_sharded
    from sim5_tpu_torch.parallel.mesh import FIT_STAGES, _stage
    reps = 20000
    cost = {}
    for name, enter in (("range", record_function), ("stage", _stage)):
        t0 = time.perf_counter()
        for _ in range(reps):
            with enter("fit.empty"):
                pass
        cost[name] = 1e6 * (time.perf_counter() - t0) / reps
    walls = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit_step_sharded(mesh, p, target, None, N_IMAGE, N_IMAGE,
                             lr=FIT_LR, opt_state=st)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    wall = walls[-1]
    events = prof.events()
    # a range shows twice, on the host and as the device's annotation
    spans = {e.name: e.time_range for e in events
             if e.name in FIT_STAGES and str(e.device_type).endswith("CPU")}
    check(sorted(spans) == sorted(FIT_STAGES),
          f"the profiler saw the fit stages {sorted(spans)}")
    stages = {name: [spans[name].elapsed_us(), 0, 0]
              for name in FIT_STAGES}
    stages["other"] = [1e6 * wall - sum(v[0] for v in stages.values()), 0,
                       0]
    by_op = Counter()
    for e in events:
        launch = e.name.startswith(("cudaLaunch", "cuLaunch"))
        if not launch and not e.name.startswith(("cudaMemcpy",
                                                 "cudaMemset")):
            continue
        at = e.time_range.start
        name = next((k for k, r in spans.items() if r.start <= at < r.end),
                    "other")
        stages[name][1 if launch else 2] += 1
        if launch:
            by_op[getattr(e.cpu_parent, "name", "(none)")] += 1
    averages = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    launches = sum(v[1] for v in stages.values())
    # the device's own events (kernels, copies), not the host ops that
    # the profiler also credits with their kernels' time, nor the
    # stages' annotations
    device = [e for e in averages if str(e.device_type).endswith("CUDA")
              and e.key not in FIT_STAGES]
    total = sum(device_us(e) for e in device)
    image = sum(device_us(e) for e in device
                if re.search(r"\bnt_(frames|image|reduce)", e.key))
    check(launches > 0 and total > 0, "the profiler saw no device work")
    split = "; ".join(f"{k} {v[0] / 1e3:.4f} ms host, {v[1]} launches, "
                      f"{v[2]} copies" for k, v in stages.items())
    top = ", ".join(f"{k} {n}" for k, n in by_op.most_common(8))
    return (f"{launches} CUDA launches, device busy {total / 1e3:.4f} ms "
            f"(image kernels {image / 1e3:.4f} ms) in a {1e3 * wall:.3f} ms "
            f"step (warm-up step {1e3 * walls[0]:.3f} ms); by stage: "
            f"{split}; launches by op: {top}; with no profiler an empty "
            f"record_function range costs {cost['range']:.3f} us, the "
            f"fit's stage {cost['stage']:.3f} us")


def run_example(name, args, full, dev, tmp):
    """examples/NAME run in this process by runpy, with `args` and the
    card's device as its arguments, SIM5_FAST unless `full`, in `tmp`:
    (its standard output, seconds)."""
    import io
    import runpy
    root = pathlib.Path(__file__).resolve().parent
    argv, cwd, env = sys.argv, os.getcwd(), os.environ.get("SIM5_FAST")
    sys.argv = [str(root / "examples" / name), *args, str(dev)]
    if full:
        os.environ.pop("SIM5_FAST", None)
    else:
        os.environ["SIM5_FAST"] = "1"
    out = io.StringIO()
    try:
        os.chdir(tmp)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            runpy.run_path(sys.argv[0], run_name="__main__")
        torch.cuda.synchronize()
        return out.getvalue(), time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        sys.argv = argv
        if env is None:
            os.environ.pop("SIM5_FAST", None)
        else:
            os.environ["SIM5_FAST"] = env


def phase_examples(dev):
    """Every examples/torch_*.py on the card in this process (runpy):
    EXAMPLES' full-size ones at full size, the others at SIM5_FAST; each
    one's printed numbers finite and not all zero (example 08 prints its
    table's progress, read back instead)."""
    from sim5_tpu_torch.tables import SpectralTable
    root = pathlib.Path(__file__).resolve().parent / "examples"
    listed = sorted(n for n, _, _ in EXAMPLES)
    check(listed == sorted(p.name for p in root.glob("torch_*.py")),
          f"phase 26 lists {listed}")
    from sim5_tpu_torch.render import kernel_analytic
    # the analytic kernel each of these examples' paths launches
    analytic = {"torch_07": kernel_analytic.CROSSING,
                "torch_11": kernel_analytic.SEEDS[torch.float64, True],
                "torch_12": kernel_analytic.CROSSING}
    parts = []
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sim5_examples_") as tmp:
        for name, args, full in EXAMPLES:
            reset_analytic()
            out, secs = run_example(name, args, full, dev, tmp)
            v = analytic.get(name[:8])
            n_v = analytic_launches()[v] if v else 0
            check(v is None or n_v >= 1, f"{name}: {v} launched "
                  f"{launched(analytic_launches())}")
            if name.startswith("torch_08"):
                spectra = SpectralTable.open(os.path.join(tmp, args[0])).spectra
                vals = spectra.ravel().tolist()
            else:
                vals = [float(v) for v in NUMBER.findall(out)]
            check(vals and all(math.isfinite(v) for v in vals)
                  and any(v != 0 for v in vals),
                  f"{name}: {len(vals)} numbers, finite and not all zero "
                  f"expected")
            parts.append(f"{name[6:8]} {'full' if full else 'fast'} "
                         f"{secs:.2f} s ({len(vals)} numbers"
                         + (f", {v} {n_v}" if v else "") + ")")
    print(f"phase 26 examples on the card "
          f"({time.perf_counter() - t_phase:.1f} s): " + ", ".join(parts),
          flush=True)


# Phase 27: emission and absorption models outside the GaussianSource
# family, traced into the march kernel (march/model_trace.py)
N_SPIRAL = 128           # the spiral's image (its f64 azimuth seed costs
                         # ~2.4 s at any size: one launch an op)
# test_march.py:177's configuration of its flare light curve, at 64^2
FLARE = dict(a=0.7, incl=math.radians(55.0), rmax=16.0, r_start=25.0,
             max_steps=384, precision=0.03, axisymmetric=True)
N_FLARE = 64
FLARE_T = (-20.0, -8.0)
ALPHA_SWEEP = (0.0, 0.05, 0.2, 1.0, 5.0)   # example 11's
N_SWEEP_IMAGE = 64                          # example 11's


def plain_torus(alpha0=None):
    """Example 11's torus as its own plain functions
    (examples/11_thick_volume_transfer.py:39-49), in torch: torus_j
    (alpha0 None), or make_alpha(alpha0) (None for alpha0 = 0)."""
    if alpha0 is None:
        return _torus_j
    if alpha0 == 0.0:
        return None

    def torus_alpha(t, r, m, phi):
        return alpha0 * _torus_j(t, r, m, phi)
    return torus_alpha


def _torus_j(t, r, m, phi):
    R = r * torch.sqrt(torch.clamp(1.0 - m * m, min=0.0))
    z = r * m
    return torch.exp(-0.5 * (((R - 8.0) / 1.5) ** 2 + (z / 1.5) ** 2))


def _corona_j(t, r, m, phi):
    return torch.where(r > 2.0, r ** -2.5, 0.0) * torch.exp(
        -0.5 * (m / 0.3) ** 2)


def _corona_alpha(t, r, m, phi):
    return 0.05 * r ** -1.5 * torch.exp(-0.5 * (m / 0.3) ** 2)


def _spiral_j(t, r, m, phi):
    R = r * torch.sqrt(torch.clamp(1.0 - m * m, min=0.0))
    return (torch.exp(-0.5 * ((R - 8.0) / 2.0) ** 2 - 0.5 * (r * m) ** 2)
            * (1.0 + 0.5 * torch.cos(2.0 * (phi - 0.05 * t)
                                     - 4.0 * torch.log(R))))


def _spiral_alpha(t, r, m, phi):
    return 0.2 * _spiral_j(t, r, m, phi)


def corona(alpha0=None):
    """A power-law corona: its emissivity (alpha0 None), or its absorption
    (None for alpha0 = 0)."""
    return _corona_j if alpha0 is None else (
        _corona_alpha if alpha0 else None)


def spiral(alpha0=None):
    """A two-armed spiral that depends on time and azimuth: its emissivity
    (alpha0 None), or its absorption, 0.2 j (None for alpha0 = 0)."""
    return _spiral_j if alpha0 is None else (
        _spiral_alpha if alpha0 else None)


class Scaled:
    """A model whose number is an attribute: scale * fn."""

    def __init__(self, fn, scale):
        self.fn, self.scale = fn, scale

    def __call__(self, t, r, m, phi):
        return self.scale * self.fn(t, r, m, phi)


def flare(r_spot=8.0, t_flare=-30.0):
    """test_march.py:235's flare, in torch."""
    def j(t, r, m, phi):
        rho2 = (r - r_spot) ** 2 + (r * m) ** 2
        return (torch.exp(-0.5 * rho2 / 1.5 ** 2)
                * torch.exp(-0.5 * ((t - t_flare) / 10.0) ** 2))
    return j


def traced_pairs():
    """Phase 27's (emissivity, absorption) pairs, by name."""
    return {"torus": (plain_torus(), None),
            "torus thick": (plain_torus(), plain_torus(1.0)),
            "corona": (corona(), None), "corona thick": (corona(), corona(1)),
            "spiral": (spiral(), None), "spiral thick": (spiral(), spiral(1)),
            "flare": (flare(), None),
            "scaled corona": (Scaled(_corona_j, 1.0), None)}


def start_generated_builds():
    """Traces phase 27's pairs here and starts one nvcc for each of their
    generated libraries, beside the phases: BACKGROUND["generated"] gives
    ({pair: library name}, {name: its BUILDS entry}, seconds until all
    were built).  The later loads (example 11 in phase 26, phase 27) find
    them cached."""
    from sim5_tpu_torch import _build
    from sim5_tpu_torch.march import kernel_march
    from sim5_tpu_torch.march.emission import prepare
    pairs = traced_pairs()
    traced = {k: prepare(em, ab)[1:] for k, (em, ab) in pairs.items()}
    t0 = time.perf_counter()

    def build(p):
        name = kernel_march.model_library(*p)[0]
        return name, dict(_build.BUILDS[name])

    def all_built():
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            built = dict(zip(traced, pool.map(build, traced.values())))
        return ({k: n for k, (n, _) in built.items()},
                {n: b for n, b in built.values()}, time.perf_counter() - t0)

    pool = concurrent.futures.ThreadPoolExecutor(1)
    BACKGROUND["generated"] = pool.submit(all_built)
    pool.shutdown(wait=False)


@contextlib.contextmanager
def generated_builds():
    """The (name, BUILDS entry) of every load of a generated march library
    in the block, in order."""
    from sim5_tpu_torch import _build
    real, log = _build.load_generated, []

    def logged(name, source):
        lib = real(name, source)
        log.append((name, dict(_build.BUILDS[name])))
        return lib

    _build.load_generated = logged
    try:
        yield log
    finally:
        _build.load_generated = real


def model_ops(em, ab):
    """The operations of one evaluation of each traced model, summed."""
    from sim5_tpu_torch.march.model_trace import trace_model
    return sum(trace_model(m).flops for m in (em, ab) if m is not None)


def phase_traced(dev, name, family_images, family_outs, family_rows,
                 family_plain, shared):
    """Emission and absorption models outside the family through the
    march kernel: (a) example 11's torus as its own plain functions at
    512^2 against the GaussianSource route of phases 7 and 9 and against
    phase 9's plain march of that torus, timed (the kernels line's rows);
    (b) a power-law corona and a spiral, thin and thick, against the plain
    version on 4096 ZAMO rays and on a 64^2 and a 512^2 seed (`shared`:
    phase 6's one plain march of the four pairs on both seeds,
    `plain_together`), timed at 512^2, the spiral's image at 128^2; (c)
    one build for models
    that differ only in their numbers, and numbers that change between
    two calls reaching the card; (d) refusals before any build or launch.
    Returns the launches of (a) and the rows."""
    from sim5_tpu_torch import _build
    from sim5_tpu_torch.march import (kernel_march, raytrace_prepare,
                                      raytrace_kernel, raytrace_reference)
    from sim5_tpu_torch.march.emission import prepare
    from sim5_tpu_torch.render import volume_image, volume_lightcurve
    t_phase = time.perf_counter()
    # every generated library of the phase, one nvcc each, all started
    # together after phase 1 (`start_generated_builds`); loaded here again
    if "generated" not in BACKGROUND:
        start_generated_builds()
    pairs = traced_pairs()
    libs, builds, build_s = BACKGROUND["generated"].result()
    with generated_builds() as log:
        for k, (em, ab) in pairs.items():
            got = kernel_march.model_library(*prepare(em, ab)[1:])[0]
            check(got == libs[k], f"{k}: library {got}, built as {libs[k]}")
    check(all(b["cached"] for _, b in log), f"a load of phase 27 built: {log}")
    cold = {k: b["seconds"] for k, b in builds.items() if not b["cached"]}
    build_text = (f"{len(builds)} libraries for {len(pairs)} pairs in "
                  f"{build_s:.2f} s together (beside phases 2-25), cold "
                  + (", ".join(f"{v:.2f}" for v in cold.values()) or "none")
                  + " s, loaded again here cached "
                  + f"{max(b['seconds'] for _, b in log):.4f} s at most: "
                  + "; ".join(
                      f"{k} {libs[k]} cached={builds[libs[k]]['cached']} "
                      f"{builds[libs[k]]['seconds']:.2f} s [ptxas "
                      f"{ptxas_summary(builds[libs[k]]['log'])}]"
                      for k in pairs))

    # (a) example 11's torus as plain functions: the main path, which
    # traces its models on every call (timed here alone, host clock)
    t0 = time.perf_counter()
    prepare(plain_torus(), plain_torus(1.0))
    trace_ms = (time.perf_counter() - t0) * 1e3
    images, launches, march, parts, gate = volume_main(dev, VOL, plain_torus)
    a_parts = [f"tracing the thick pair {trace_ms:.1f} ms"]
    for alpha0 in ALPHA0:
        fam, got = family_images[alpha0], images[alpha0]
        peak = float(fam.max())
        err = float((got - fam).abs().max())
        check(err <= 1e-5 * peak, f"torus alpha0={alpha0}: traced vs "
              f"family {err / peak:.3e} of the peak > 1e-5")
        a_parts.append(f"alpha0={alpha0}: image vs GaussianSource route "
                       f"{err:.3e} = {err / peak:.3e} of peak (gate 1e-5), "
                       f"bitwise {torch.equal(got, fam)}")
    (st0, tensors), scalars = shared["big"], shared["scalars"]
    rows, torus_ms = {}, {}
    for alpha0 in ALPHA0:
        rt = 1 if alpha0 == 0.0 else 2
        em, ab = plain_torus(), plain_torus(alpha0)
        tag = f"traced torus {N_VOL_PIX}^2 alpha0={alpha0}"
        _, tj, ta = prepare(em, ab)     # traced before the timed runs
        timing, same = march_timing(
            tensors, dict(scalars, emissivity=tj, absorption=ta))
        outs, fam, plain = timing[1], family_outs[rt], family_plain[rt]
        eq = float((outs[5] == fam[5]).double().mean())
        dI = float((outs[7].double() - fam[7].double()).abs().max())
        peak = float(fam[7].double().max())
        check(eq > 0.999, f"{tag}: equal steps with the family {eq:.5f} of "
              f"the rays <= 0.999")
        eq_p, _, dI_p, peak_p = compare_transfer(outs, plain, st0)
        check(eq_p > 0.9 and dI_p <= 1e-3 * peak_p,
              f"{tag} vs plain: equal steps {eq_p:.4f} (> 0.9), |dI| "
              f"{dI_p:.3e} of peak {peak_p:.4e} (<= 1e-3)")

        def max_dI(outs, plain):
            return compare_transfer(outs, plain, st0)[2]

        text, rows[rt] = timing_report(
            tag, N_VOL_PIX ** 2, rt, timing, same, plain,
            family_rows[rt]["plain_ms"], max_dI, model_ops(em, ab))
        torus_ms[rt] = timing[0]
        a_parts.append(
            f"alpha0={alpha0} march {text} (phase 9's plain march of this "
            f"torus, the GaussianSource form) | family {family_rows[rt]['ms']:.3f} "
            f"ms, ratio {timing[0] / family_rows[rt]['ms']:.4f} | vs family: "
            f"equal steps {eq:.6f} (gate > 0.999) |dI| {dI / peak:.3e} of "
            f"peak, bitwise {same_bits(outs, fam)} | vs plain: equal steps "
            f"{eq_p:.4f} |dI| {dI_p / peak_p:.3e} of peak")

    # (b) the corona and the spiral against their plain version: on ZAMO
    # rays through raytrace_kernel, and on the 64^2 seed of each one's
    # configuration and the torus's 512^2 seed (phase 6's plain march),
    # timed there
    names = TRACED_CMP
    x, k, _ = zamo_rays(N_CMP, 0.9, seed=0, dtype=torch.float32, device=dev)
    st_z = raytrace_prepare(0.9, x, k, precision=0.01)
    zamo_kw = dict(r_max=50.0, max_steps=300)
    # the plain march of the four pairs on the ZAMO rays in one call, held
    # bitwise against the plain version of the last pair alone
    t0 = time.perf_counter()
    zt, zs = kernel_march._pack(st_z, zamo_kw["r_max"], zamo_kw["max_steps"],
                                1e-2, None)
    together = dict(zip(names, plain_together(
        [(zt, *pairs[p]) for p in names], zs)))
    torch.cuda.synchronize()
    zamo_s = time.perf_counter() - t0
    alone = names[-1]
    sp, ap, Ip = raytrace_reference(st_z, **dict(
        zamo_kw, emissivity=pairs[alone][0], absorption=pairs[alone][1]))
    st_t, act_t, I_t = kernel_march._unpack(st_z, together[alone])
    check(same_bits((st_t.x, st_t.steps, act_t, I_t), (sp.x, sp.steps, ap, Ip)),
          f"{alone}: the plain march of the four pairs together is not "
          f"bitwise the plain march of {alone} alone on {N_CMP} rays")
    small, plains, kernel, texts = shared["small"], shared["plains"], {}, {}
    for pair in names:
        em, ab = pairs[pair]
        sk, _, Ik = raytrace_kernel(st_z, **dict(zamo_kw, emissivity=em,
                                                 absorption=ab))
        sp, _, Ip = kernel_march._unpack(st_z, together[pair])
        torch.cuda.synchronize()
        eq_r = (sk.steps == sp.steps)
        peak_r = float(Ip.double().max())
        dI_r = float((Ik.double() - Ip.double()).abs()[eq_r].max())
        eq_r = float(eq_r.double().mean())
        check(peak_r > 0.0 and eq_r > 0.9 and dI_r <= 1e-3 * peak_r,
              f"{pair}, {N_CMP} rays: equal steps {eq_r:.4f} (> 0.9), |dI| "
              f"{dI_r:.3e} of peak {peak_r:.4e} (<= 1e-3)")
        texts[pair] = (f"{N_CMP} rays equal steps {eq_r:.4f} |dI| "
                       f"{dI_r / peak_r:.3e} of peak")
        _, tj, ta = prepare(em, ab)
        models = dict(emissivity=tj, absorption=ta)
        out_c = kernel_march._march_cuda(*small[pair.startswith("corona")][1],
                                         **scalars, **models)
        timing, same = march_timing(tensors, dict(scalars, **models))
        check(same, f"{pair} {N_VOL_PIX}^2: two runs differ")
        kernel[pair] = (out_c, timing)
    b_parts, big_ms = [], {}
    for pair in names:
        em, ab = pairs[pair]
        rt = 1 if ab is None else 2
        st0c = small[pair.startswith("corona")][0]
        out_c, (ms, out_k, _) = kernel[pair]
        eq, _, dI, peak = compare_transfer(out_c, plains[pair][0], st0c)
        check(peak > 0.0 and eq > 0.9 and dI <= 1e-3 * peak,
              f"{pair}, {N_VOL_CMP}^2 seed: equal steps {eq:.4f} (> 0.9), "
              f"|dI| {dI:.3e} of peak {peak:.4e} (<= 1e-3)")
        # at 512^2 the gate holds off the photon orbits: the corona shines
        # where the rays circling them run
        big_p = plains[pair][1]
        eq_b, _, dI_all, peak_b = compare_transfer(out_k, big_p, st0)
        dI_b, n_cap, dI_cap = compare_off_orbit(out_k, big_p, st0, VOL["a"])
        check(peak_b > 0.0 and eq_b > 0.9 and dI_b <= 1e-3 * peak_b,
              f"{pair}, {N_VOL_PIX}^2 torus seed: equal steps {eq_b:.4f} "
              f"(> 0.9), |dI| {dI_b:.3e} of peak {peak_b:.4e} off the "
              f"photon orbits (<= 1e-3)")
        steps = int(out_k[5].long().sum())
        bound, _ = march_bound(N_VOL_PIX ** 2, steps, rt, model_ops(em, ab))
        big_ms[pair] = ms
        b_parts.append(
            f"{pair} ({model_ops(em, ab)} model ops a step): {texts[pair]}; "
            f"{N_VOL_CMP}^2 seed equal steps {eq:.4f} |dI| {dI / peak:.3e} "
            f"of peak {peak:.4e}; {N_VOL_PIX}^2 torus seed equal steps "
            f"{eq_b:.4f} |dI| {dI_b / peak_b:.3e} of peak {peak_b:.4e} off "
            f"the photon orbits; {n_cap} rays circling them at the "
            f"{scalars['max_steps']}-step cap, |dI| up to "
            f"{dI_cap / peak_b:.3e} of peak (all equal-step rays "
            f"{dI_all / peak_b:.3e}); x and steps bitwise the family "
            f"march's on these rays (phase 9): "
            f"{same_bits(out_k[:6], family_outs[rt][:6])}; march {ms:.3f} "
            f"ms (min of {TIMED_RUNS}; traced torus {torus_ms[rt]:.3f} ms, "
            f"ratio {ms / torus_ms[rt]:.4f}) {steps / (ms * 1e-3):.4e} "
            f"ray-steps/s, bound {bound:.3f} ms")
    b_parts.append(
        f"the plain march of the four pairs in one call on the {N_CMP} ZAMO "
        f"rays ({zamo_s:.1f} s host clock), {alone}'s part bitwise its own "
        f"plain march; on the {N_VOL_CMP}^2 and {N_VOL_PIX}^2 seeds in "
        f"phase 6's one call ({shared['plain_s']:.1f} s host clock)")
    for alpha0 in ALPHA0:
        kernel_march.LAUNCHES.update(dict.fromkeys(kernel_march.LAUNCHES, 0))
        t0 = time.perf_counter()
        with launch_events() as events:
            I = volume_image(VOL["a"], VOL["incl"], spiral(), engine="kernel",
                             absorption_fn=spiral(alpha0),
                             **dict(volume_kw(VOL, N_SPIRAL),
                                    axisymmetric=False))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        v = kernel_march.VARIANTS[3 if alpha0 == 0.0 else 4]
        check(kernel_march.LAUNCHES[v] >= 1, f"spiral image: {v} 0 times")
        check(bool(torch.isfinite(I).all()) and float(I.max()) > 0.0,
              f"spiral image alpha0={alpha0}: not finite and positive")
        b_parts.append(
            f"spiral {N_SPIRAL}^2 alpha0={alpha0} image {wall:.3f} s (host "
            f"clock, with its f64 azimuth seed), march "
            f"{sum(a.elapsed_time(b) for a, b in events):.3f} ms, "
            f"{v} LAUNCHES={kernel_march.LAUNCHES[v]}, flux "
            f"{float(I.double().sum()):.6e}")

    # (c) one build for models that differ only in their numbers
    with generated_builds() as log:
        kw = dict(engine="kernel", device=dev, **volume_kw(FLARE, N_FLARE))
        f1 = volume_lightcurve(FLARE["a"], FLARE["incl"], flare(), FLARE_T,
                               **kw)
        f2 = volume_lightcurve(FLARE["a"], FLARE["incl"],
                               flare(t_flare=-12.0), FLARE_T, **kw)
        sweep = [float(volume_image(
            VOL["a"], VOL["incl"], plain_torus(), engine="kernel",
            absorption_fn=plain_torus(a0), device=dev,
            **volume_kw(VOL, N_SWEEP_IMAGE)).double().sum())
            for a0 in ALPHA_SWEEP]
    flare_libs = {n for n, _ in log[:4]}
    sweep_libs = [n for n, _ in log[4:]]
    check(len(flare_libs) == 1 and flare_libs == {libs["flare"]},
          f"the flares at two times and two t_flare: libraries {flare_libs}")
    check(len(set(sweep_libs[1:])) == 1 and sweep_libs[1:][0] ==
          libs["torus thick"] and sweep_libs[0] == libs["torus"],
          f"example 11's alpha sweep: libraries {sweep_libs}")
    check(all(b["cached"] for _, b in log), "a load of phase 27 (c) built")
    check(all(math.isfinite(v) and v > 0 for v in list(f1) + list(f2)),
          f"flare light curves {f1} {f2}")
    check(all(a > b for a, b in zip(sweep, sweep[1:])),
          f"example 11's sweep: flux does not fall as alpha grows: {sweep}")
    cached_s = [b["seconds"] for _, b in log]
    # a number the model reads changed between two calls reaches the card
    scaled = pairs["scaled corona"][0]
    with generated_builds() as scaled_log:
        I1 = raytrace_kernel(st_z, emissivity=scaled, **zamo_kw)[2].double()
        scaled.scale = 2.0
        I2 = raytrace_kernel(st_z, emissivity=scaled, **zamo_kw)[2].double()
    d2 = float((I2 - 2.0 * I1).abs().max())
    peak = float(I2.max())
    check(peak > 0.0 and d2 <= 1e-6 * peak, f"a scale changed from 1 to 2 "
          f"between two calls: I2 - 2 I1 {d2:.3e} of peak {peak:.4e}")
    check({n for n, _ in scaled_log} == {libs["scaled corona"]}
          and all(b["cached"] for _, b in scaled_log),
          f"the scaled corona's loads: {scaled_log}")
    c_text = (f"a scale changed from 1 to 2 between two raytrace_kernel "
              f"calls: |I2 - 2 I1| {d2 / peak:.3e} of peak (gate 1e-6), "
              f"bitwise {torch.equal(I2, 2.0 * I1)}, one cached library; "
              f"flare light curve at t0 {FLARE_T}: "
              + ", ".join(f"{v:.6e}" for v in f1) + "; at t_flare -12: "
              + ", ".join(f"{v:.6e}" for v in f2)
              + f": {len(log[:4])} loads of 1 library ({libs['flare']}); "
              f"example 11's sweep alpha0 {ALPHA_SWEEP} at {N_SWEEP_IMAGE}^2, "
              f"flux " + ", ".join(f"{v:.6e}" for v in sweep)
              + f": thin {sweep_libs[0]}, "
              f"{len(sweep_libs) - 1} absorptions 1 library "
              f"({sweep_libs[1]}); every load cached, "
              f"{min(cached_s):.4f}-{max(cached_s):.4f} s")

    # (d) refusals on the card, before any build or launch
    def unsupported(t, r, m, phi):
        return r / r.amax()

    def branchy(t, r, m, phi):
        return r if bool((r > 3.0).all()) else m

    launches0, builds0 = dict(kernel_march.LAUNCHES), dict(_build.BUILDS)
    d_parts = []
    for fn in (unsupported, branchy):
        for call in (lambda: volume_image(VOL["a"], VOL["incl"], fn,
                                          engine="kernel", device=dev,
                                          **volume_kw(VOL, 16)),
                     lambda: raytrace_kernel(st0, emissivity=fn,
                                             max_steps=10)):
            try:
                call()
                raised = None
            except TypeError as e:
                raised = str(e)
            check(raised is not None, f"{fn.__name__} was not refused")
        d_parts.append(f"{fn.__name__}: {raised[:90]}")
    check(kernel_march.LAUNCHES == launches0 and _build.BUILDS == builds0,
          "a refused model launched or built")

    secs = time.perf_counter() - t_phase
    print(f"phase 27 traced models in the march kernel ({secs:.1f} s; {name}) "
          f"| builds: {build_text} | (a) example 11's torus as plain "
          f"functions, {N_VOL_PIX}^2: " + " | ".join(parts) + f" | {gate} | "
          + " | ".join(a_parts) + " | (b) " + " | ".join(b_parts)
          + f" | (c) {c_text} | (d) refused before any launch or build: "
          + "; ".join(d_parts), flush=True)
    rows[1]["corona_512_ms"], rows[2]["corona_512_ms"] = (
        big_ms["corona"], big_ms["corona thick"])
    return launches, rows


def launched(counts):
    """The kernels of a LAUNCHES dict launched at least once."""
    return {k: v for k, v in counts.items() if v}


def _native_hash():
    """sha256 of the files under native/ (the JAX package's writer)."""
    h = hashlib.sha256()
    root = pathlib.Path(__file__).resolve().parent / "native"
    for p in sorted(root.iterdir()):
        h.update(p.name.encode() + p.read_bytes())
    return h.hexdigest()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if sys.argv[1:2] == ["--forward-hashes"]:
        sys.path.insert(0, sys.argv[2])
        print(json.dumps(forward_hashes(dev)))
        return 0
    if sys.argv[1:2] == ["--compare-forward"]:
        return compare_forward(sys.argv[2])
    if sys.argv[1:2] == ["--grad-times"]:
        sys.path.insert(0, sys.argv[2])
        print(json.dumps(grad_times(dev)))
        return 0
    if sys.argv[1:2] == ["--compare-grad"]:
        return compare_grad(sys.argv[2])
    if sys.argv[1:2] == ["--analytic-times"]:
        sys.path.insert(0, sys.argv[2])
        print(json.dumps(analytic_times(dev, sys.argv[3])))
        return 0
    if sys.argv[1:2] == ["--compare-analytic"]:
        return compare_analytic(sys.argv[2])
    if sys.argv[1:2] == ["--tune-analytic"]:
        try:
            return tune_analytic(dev)
        except PhaseFailed as e:
            print(f"FAILED: {e}", file=sys.stderr)
            return 1
    if sys.argv[1:2] == ["--tune-tangent"]:
        try:
            return tune_tangent(dev)
        except PhaseFailed as e:
            print(f"FAILED: {e}", file=sys.stderr)
            return 1
    t_start = time.perf_counter()
    native_hash = _native_hash()
    seconds = []

    def run(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        seconds.append(f"{label} {time.perf_counter() - t0:.1f}")
        return out

    cpu_pool = start_cpu_references()
    try:
        name, lengths = run("1", phase_device)
        start_generated_builds()
        run("2", phase_compare, dev)
        launches, _ = run("3", phase_main, dev)
        run("4", phase_f64, dev)
        t = run("5", phase_timing, dev, name)
        shared = run("6", phase_transfer_compare, dev)
        vol_launches, vol_images = run("7", phase_volume_main, dev)
        run("8", phase_volume_loop, dev)
        vol_t, vol_outs, vol_plain = run("9", phase_volume_timing, dev, name)
        run("10", phase_image_golden, dev)
        image_launches, image_errs, _, image_counts = run(
            "11", phase_image_main, dev)
        image_t = run("12", phase_image_timing, dev, name, image_errs,
                      image_counts, lengths)
        analytic_rows = run("28", phase_analytic_kernels, dev, name, lengths)
        run("13", phase_analytic, dev)
        orbit_launches, orbit_rows = run("14", phase_orbit_volume, dev, name)
        hotspot = run("15", phase_hotspot, dev)
        run("16", phase_shadow, dev)
        run("17", phase_polarized, dev)
        run("18", phase_lineprofile, dev)
        run("19", phase_thickdisk, dev)
        run("20", phase_driver_spectra, dev)
        run("1 (tangent library)", tangent_build)
        grad_rows = run("21", phase_image_grad, dev, image_counts, lengths)
        run("22", phase_scan, dev)
        with tempfile.TemporaryDirectory(prefix="sim5_smoke_") as tmp:
            run("23", phase_tables, dev, tmp)
            run("24", phase_checkpoints, dev, tmp, native_hash)
        run("25", phase_parallel, dev)
        run("27 (generated libraries)", BACKGROUND["generated"].result)
        run("26", phase_examples, dev)
        traced_launches, traced_rows = run(
            "27", phase_traced, dev, name, vol_images, vol_outs, vol_t,
            vol_plain, shared)
    except PhaseFailed as e:
        print(f"FAILED: {e} (phase seconds: {', '.join(seconds)})",
              file=sys.stderr)
        return 1
    finally:
        cpu_pool.shutdown(cancel_futures=True)
    print(f"phase seconds (host clock, waits included): {', '.join(seconds)}",
          flush=True)
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    from sim5_tpu_torch.march import kernel_march
    march_src = dict(route="cuda", source="sim5_tpu_torch/csrc/march.cu",
                     replaces="sim5_tpu/march/pallas_march.py:296")
    image_src = dict(route="cuda",
                     source="sim5_tpu_torch/csrc/disk_image.cu",
                     replaces="sim5_tpu/render/image.py:35 (XLA-fused jnp; "
                              "no Pallas kernel)")
    rows = []
    for rt, timing in {0: t, **vol_t}.items():
        v = kernel_march.VARIANTS[rt]
        extra = ({} if rt == 0 else {
            f"orbiting_{k}": orbit_rows[rt][k] for k in (
                "ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by")})
        if rt:
            extra["orbiting_launches"] = orbit_launches[v]
        rows.append((v, dict(march_src, **extra),
                     (launches if rt == 0 else vol_launches)[v], timing))
    traced_src = dict(march_src, source="sim5_tpu_torch/csrc/march.cuh "
                      "with the functors of sim5_tpu_torch/march/"
                      "model_trace.py (build/sim5_tpu_torch/gen/)")
    for rt, row in traced_rows.items():
        v = kernel_march.VARIANTS[rt + 2]
        rows.append((v, dict(traced_src, **{
            k: row[k] for k in row if k.endswith("_512_ms")}),
            traced_launches[v], row))
    from sim5_tpu_torch.render import kernel_image
    for dt, v in kernel_image.VARIANTS.items():
        pro = kernel_image.PROLOGUES[dt]
        rows.append((f"{pro} + {v}", image_src,
                     image_launches[pro] + image_launches[v], image_t[v]))
    jvp_src = dict(route="cuda",
                   source="sim5_tpu_torch/csrc/disk_image_jvp.cu",
                   replaces="sim5_tpu/render/image.py:35 under jax.jvp / "
                            "jax.grad (XLA autodiff; no Pallas kernel)")
    for dt, r in grad_rows.items():
        rows.append((r["name"], jvp_src, r["launches"], r))
    # the analytic kernels' passes, each with the launches of its main
    # path: the light curve's entry point (phase 15), the orbiting spot's
    # image (phase 14) and the torus's (phase 7)
    from sim5_tpu_torch.render import kernel_analytic as ka
    crossing_src = dict(
        route="cuda", source="sim5_tpu_torch/csrc/crossing_map.cu",
        replaces="sim5_tpu/render/lightcurve.py:33 (the XLA program "
                 "equatorial_crossing_map; no Pallas kernel)")
    for pv in ka.PASSES[ka.CROSSING]:
        rows.append((pv, crossing_src, hotspot["launches"][pv],
                     analytic_rows[pv]))
    seed_src = dict(route="cuda", source="sim5_tpu_torch/csrc/volume_seed.cu",
                    replaces="sim5_tpu/render/lightcurve.py:113, 127, 138 "
                             "(the XLA programs _volume_seed_geom, _azm, "
                             "_pack; no Pallas kernel)")
    for v, counts in ((seed_name(VOL_SPOT), orbit_launches),
                      (seed_name(VOL), vol_launches)):
        for pv in ka.PASSES[v]:
            rows.append((pv, seed_src, counts[pv], analytic_rows[pv]))
    print(json.dumps({"kernels": [{
        "name": v, **src, "launches": n, "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None}
        for v, src, n, r in rows]}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

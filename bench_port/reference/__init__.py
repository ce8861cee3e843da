"""The benchmark's plain reference: a frozen copy of the port's plain torch
chains, which imports nothing of the port.

`core`, `special`, `geodesic`, `utils.fastmath`, `consts`, `disk.nt` and
`march.raytrace` are copies of the port's modules of the same paths (less
the tetrads, interpolation tables, distributions and root finder, which no
chain here calls), kept here so that the yardstick does not move when the
port does; their imports are relative, inside this package.  `nt_image`,
`volume` and `crossing` assemble them into the answers the benchmark's
cells compare: the NT image and its gradient, the orbiting spot's volume
image, and the hot spot's light curve.  Every function takes its dtype, so the same code
is the reference (the configuration's precision or above) and the control
(the nearest precision below it).
"""

"""The benchmark of `sim5_tpu_torch`, the port to PyTorch and CUDA.

`run.py` is the command; `harness.py` runs one cell of `BENCHMARK.json`;
`registry.py` finds a cell's configuration (`configs/`), traffic mix
(`traffic/`), cell file (`cells/`), entry (`entries/`), per-layer metric
readers (`metrics/`) and frozen work counts (`work/`) by name; `traffic.py`
is the one generator of every mix; `stats.py` the arithmetic of the
metrics; `trace.py` reads the profiler's trace; `roofline.py` the peaks
and the least time of a piece of work; `reference/` the plain reference
the answers are judged against; `held.json` the entries of cells built
but held out of `BENCHMARK.json`, which the tests still run.  Nothing here
imports `jax` or the JAX package.
"""

"""The benchmark of veneur_tpu_torch, the PyTorch and CUDA package.

One run (`python3 -m bench_port.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`) builds one cell's traffic from the seed,
starts the package's Server in process, feeds it whole 10-s intervals
through the entry its listeners use, plays the flush ticker itself,
and holds every flushed interval to a plain NumPy reference.

Everything a cell needs is found by name from BENCHMARK.json:

- `configs/<config>.json`: the Server's config keys, with `source`,
  `reduced`, `assumed`, and the comparison's limits;
- `traffic/<mix>.json`: a mix's parameters; its `kind` names
- `kinds/<kind>.py`: the module that turns a mix and a seed into a
  corpus (`corpus`), holds the plain reference's answer for it
  (`reference`) and hands each item to the Server (`put`);
- `metrics/<metric>.py`: one reader per per-layer metric, tried by the
  metric's whole name and then without its last dotted part.

`generate.py` and `reference.py` hold what the kinds share, `peaks.py`
the card's peaks and the kernels' work arithmetic, `trace.py` the
profiler's reading, `faults.py` the faults the comparison must catch
and `readings.py` the runs its limits are set from. Nothing here
imports jax, veneur_tpu or benchmarks.
"""

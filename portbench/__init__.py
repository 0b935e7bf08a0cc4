"""The benchmark of ``repro_torch``, the PyTorch/CUDA port of PCILT, on one
NVIDIA H100.

``python3 portbench/run.py --workload NAME --seed N --seconds S --trace
0|1`` runs one cell of ``BENCHMARK.json`` from the root of a checkout and
prints one JSON line.  Everything that belongs to one configuration, one
traffic mix or one metric sits in a file of its own, found by its name:

* ``configs/<config>.json``: the sizes as run; its ``"kind"`` names the
  kind ``kinds/<kind>.py`` (how the port is set up, served and judged)
  and its ``"reference"`` the plain PyTorch reference
  ``reference/<reference>.py``;
* ``traffic/<traffic>.json``: the parameters that :mod:`portbench.traffic`
  turns into requests;
* ``limits/<workload>.json``: each number ``correct`` compares, with its
  limit and the readings the limit was set from;
* ``metrics/<metric>.py``: a reader ``read(rec)`` of one metric from the
  run's record (see :mod:`portbench.harness`);
* ``pending/<workload>.json``: the entries of a cell that is built and
  proven but not yet in ``BENCHMARK.json``.

Nothing here imports ``jax`` or the JAX package ``repro``; the references
import nothing of ``repro_torch``.
"""

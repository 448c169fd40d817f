"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

One command runs one cell once (``python3 ktbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``); ``BENCHMARK.json`` at the
repository's root lists the cells, configurations and metrics, and every
one of them is a file here found by its name:

- ``configs/<config>.json``: a deployment (graph generator, its
  parameters, what was cut and what assumed);
- ``traffic/<mix>.json``: a traffic mix, read by the one generator in
  :mod:`ktbench.clients`;
- ``graph_generators/<generator>.py`` and ``drivers/<kind>.py``: a
  configuration's graph generator other than ``rmat``, and a mix's driver
  of a kind other than ``decompose`` and ``stream`` (:mod:`ktbench.by_file`);
- ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: a
  metric's reader.

The yardstick lives here and nowhere in the program: the graph generators
(:mod:`ktbench.generators`), the update generator (:mod:`ktbench.updates`),
the plain reference (:mod:`ktbench.reference`), the roofline counts
(:mod:`ktbench.roofline`) and the comparison that decides ``correct``
(:mod:`ktbench.check`).  :mod:`ktbench.control` runs the control that the
comparison has to fail; :mod:`ktbench.series` runs a cell several times
and prints the spread.  Nothing here imports JAX or the JAX package.
"""

"""The benchmark of the PyTorch and CUDA port (``tensorframes_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON result line. The
cells, configurations and metrics are listed in ``BENCHMARK.json`` at the
root of the checkout; each lives in a file of its own that the harness
finds by name:

- ``portbench/configs/<config>.json``: a configuration (sizes, source,
  precision);
- ``portbench/workloads/<cell>.json``: a cell (its configuration, driver,
  traffic parameters, correctness limits and ``why``);
- ``portbench/drivers/<kind>.py``: a query or job kind (a ``Cell`` class);
- ``portbench/metrics/<metric>.py``: a metric's reader (``read(ctx)``).

Nothing here imports JAX or the JAX package, and the plain references
(``reference.py``) import nothing of the port.
"""

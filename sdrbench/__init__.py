"""The benchmark of ``tpu_sdr_torch``: one run of one cell of
``BENCHMARK.json`` on one card.

    python3 -m sdrbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives
it: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` and the code that runs the configuration's receiver,
``receivers/<receiver>.py``.  The yardstick lives here too, apart from the
program: the capture generator (``capture``), the plain reference that
decides ``correct`` (``reference/``), the table of peaks and the kernels'
bytes and operations (``roofline``) and the reading of the trace
(``trace``).  Nothing here imports JAX or the JAX package.
"""

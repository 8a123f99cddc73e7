"""The benchmark of neilpy_tpu_torch on one CUDA card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout runs one cell of
``BENCHMARK.json`` and prints one JSON result line (``run.py``).  The
harness is driven by data: a cell names a configuration
(``configs/<config>.json``, driven by ``systems/<config>.py`` and judged
by the plain reference ``reference/<config>.py``) and a traffic mix
(``traffic/<traffic>.json``); each per-layer metric is a reader of its
own (``metrics/<metric>.py``).  Nothing here imports JAX or the JAX
package, and ``reference/`` imports nothing of the port.
"""

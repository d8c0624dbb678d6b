"""portbench: the benchmark of ``repro_torch``, the PyTorch and CUDA port.

One command runs one cell (a configuration under a traffic mix) on the
machine it is started on and prints one JSON result line::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell on more than one chip runs as that many rank processes, one to a
card, in lockstep (``ranks.py``).

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own and is found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``   -- sizes, aggregates, guarantee and limits;
* ``tables/<generator>.py``   -- draws the configuration's table from a seed;
* ``reference/<name>.py``     -- the plain reference the results are held to;
* ``entries/<entry>.py``      -- where a configuration names one, the
  program entry it runs (default: ``repro_torch.ops.groupby_agg``);
* ``traffic/<traffic>.json``  -- parameters of the one traffic generator
  (``traffic.py``);
* ``metrics/<metric>.py``     -- one reader per metric, ``read(run)``.

The yardstick (``work.py``: the least bytes and operations of a query;
``peaks.json``: the device's published peaks; ``checks.py``: what decides
``correct``) lives here too, so the program under test cannot move it.
Nothing here imports ``jax`` or the JAX package ``repro``; the references
import nothing of ``repro_torch``.
"""

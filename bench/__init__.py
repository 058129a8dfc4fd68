"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line.
Everything that belongs to one kind of model, configuration, traffic mix,
cell or per-layer metric lives in a file of its own, found by its name
(``kinds/``, ``configs/``, ``traffic/``, ``workloads/``, ``cuts/``,
``metrics/``); the yardstick (``counts/``, ``reference/``, ``window.py``,
``compare.py``, ``devtrace.py``) imports nothing of the port.
"""

"""Inputs made from ``--seed``: the traffic mixes (``<traffic>.json``, read
by :mod:`bench.traffic.generator`) and the weights
(:mod:`bench.traffic.weights`).  The port and the reference are handed the
same inputs."""

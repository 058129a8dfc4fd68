"""What differs between kinds of model, one module each, found by the
configuration file's ``kind``: ``bench/kinds/<kind>.py`` is the one place
that knows its architecture, so a new architecture enters the benchmark as
new files (a kind module, a reference, a configuration, a traffic mix, a
cell, a CPU cut) and its entries in ``BENCHMARK.json``.

A kind module provides:

* ``RATE``: ``(name, unit)`` of the end-to-end rate a cell of the kind
  reports; ``UNIT_NAME``: what that rate counts;
* ``units_per_row(config, mix)``: the rate's units in one store row;
* ``model_flops_per_row(config, mix)``: the model FLOPs of training a row;
* ``program(config, device)``: the port's ``(cfg, opt, step)``, built by
  the port's launcher;
* ``make_batch(cfg, capacity)``: the launcher's batch function;
* ``batch_rows(batch)``: the leaves of a program batch that carry the
  store's rows; ``expected_rows(rows, config)``: what they hold for those
  store rows;
* ``reference_step(params, rows, config, mix, rnd)``: the plain reference's
  ``(loss, {leaf: gradient})`` of one step over ``rows``;
* ``layout(config)``: the weights as ``[(name, shape, dtype name, (init,
  arg)), ...]``, in the order the port's init gives its leaves, with the
  inits ``bench/traffic/weights.py`` draws (``normal`` scale, ``const``
  value, ``dt_range`` (lo, hi), ``a_log``);
* ``data(config, mix, gen, device)``: every row of the store, drawn from
  ``gen`` (the seed's data stream) on ``device``;
* for the CPU tests: ``DTYPE_KEYS`` (the ``model`` keys a test's dtype
  sets), ``CONTROL_ROWS`` (the rows of each checked step the control's test
  follows; None: all) and ``PROGRAM_LOSS`` (``(module, function)`` of the
  port's loss, which a planted fault cuts to half of each batch)."""
from __future__ import annotations

import importlib


def get(kind: str):
    return importlib.import_module(f"bench.kinds.{kind}")

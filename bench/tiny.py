"""Tiny versions of the benchmark's cells, for the CPU tests: the same
files' configurations and traffic with every size cut, and the port in
float32 where the configuration says so."""
from __future__ import annotations

from bench import manifest
from bench.traffic import generator

#: the cells' cut sizes: (configuration changes, traffic changes)
CUTS = {
    "cosmoflow.solar-spill": (
        {"input_shape": [16, 16, 16, 4], "depth": 2, "base_channels": 16},
        {"num_samples": 64, "num_nodes": 2, "local_batch": 4, "buffer_size": 8,
         "num_workers": 2, "num_epochs": 4, "warmup_steps": 5, "pfs_latency_s": 0.0}),
    "hymba-1.5b.train-solar-2k": (
        {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab_size": 256, "ssm_state": 8, "ssm_dt_rank": 4,
         "sliding_window": 32, "grad_accum": 2},
        {"num_samples": 40, "seq_len": 64, "buffer_size": 8, "num_epochs": 4,
         "warmup_steps": 4}),
}


#: larger cuts for the control's test: at the smallest sizes a lower
#: precision's rounding has too few products to add up in
CONTROL_CUTS = {
    "cosmoflow.solar-spill": (
        {"input_shape": [32, 32, 32, 4], "depth": 4, "base_channels": 16},
        {"num_samples": 64, "num_nodes": 2, "local_batch": 4, "buffer_size": 8,
         "num_workers": 2, "num_epochs": 4, "warmup_steps": 5, "pfs_latency_s": 0.0}),
    "hymba-1.5b.train-solar-2k": (
        {"num_layers": 8, "d_model": 256, "num_heads": 4, "num_kv_heads": 2, "head_dim": 64,
         "d_ff": 704, "vocab_size": 4096, "ssm_state": 16, "ssm_dt_rank": 16,
         "sliding_window": 128, "grad_accum": 2},
        {"num_samples": 40, "seq_len": 256, "buffer_size": 8, "num_epochs": 4,
         "warmup_steps": 4}),
}


def cell(name: str, dtype: str | None = None, control: bool = False) -> tuple[dict, dict]:
    """(configuration, traffic) of cell ``name`` cut to a CPU test's size
    (with ``control``, the control test's); ``dtype`` sets an LM's parameter
    and compute dtype."""
    wl = manifest.workload(name)
    config, mix = manifest.config(wl["config"]), generator.load(wl["traffic"])
    model_cut, mix_cut = (CONTROL_CUTS.get(name, CUTS[name]) if control else CUTS[name])
    config["model"].update(model_cut)
    if dtype is not None and config["kind"] == "lm":
        config["model"].update(param_dtype=dtype, compute_dtype=dtype)
    mix.update(mix_cut)
    return config, mix

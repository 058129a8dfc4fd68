"""The port stands alone: importing any of its modules pulls in neither JAX
nor anything of the JAX package, and its entry points refuse to run
without a card unless the caller asks for the CPU."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    __import__(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _PROBE], env=env, text=True,
                         capture_output=True, timeout=120, check=True)
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    for name in ("repro_torch.kernels.flash_attention", "repro_torch.kernels.ops",
                 "repro_torch.kernels.selective_scan", "repro_torch.kernels.rmsnorm",
                 "repro_torch.configs.hymba_1_5b", "repro_torch.configs.falcon_mamba_7b",
                 "repro_torch.models.lm", "repro_torch.serve.engine",
                 "repro_torch.launch.serve", "repro_torch.convert",
                 "repro_torch.configs.surrogates", "repro_torch.obs.trace",
                 "repro_torch.core.plan", "repro_torch.core.planners",
                 "repro_torch.core.scheduler", "repro_torch.data.backends.hdf5",
                 "repro_torch.data.backends.sharded", "repro_torch.data.storage",
                 "repro_torch.data.loaders", "repro_torch.data.prefetch",
                 "repro_torch.data.peer", "repro_torch.data.pipeline",
                 "repro_torch.models.cnn", "repro_torch.optim.adamw",
                 "repro_torch.distributed.compression", "repro_torch.train.step",
                 "repro_torch.train.trainer", "repro_torch.checkpoint.checkpoint",
                 "repro_torch.launch.train_surrogate"):
        assert name in report["imported"]


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_lm(cfg)
    params = lm.init_lm(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen2-0.5b", "--reduced"])
    from repro_torch.configs.surrogates import SURROGATES
    from repro_torch.launch import train_surrogate
    from repro_torch.models import cnn
    from repro_torch.train.trainer import Trainer

    scfg = SURROGATES["ptychonn"].reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cnn.Surrogate(scfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_surrogate.main(["--arch", "ptychonn", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(loader=[], step_fn=None, state={}, make_batch=None)
    # asked for explicitly, the CPU works
    out = ServeEngine(cfg, params, max_len=16, device="cpu").generate(
        np.zeros((1, 4), np.int32), 2)
    assert out.shape == (1, 2)


def test_other_families_are_not_ported_yet():
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config("qwen2-0.5b").reduced().replace(family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lm.init_lm(cfg, device="cpu")

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
                 "repro_torch.launch.train_surrogate", "repro_torch.launch.train",
                 "repro_torch.configs.deepseek_7b", "repro_torch.configs.minitron_8b",
                 "repro_torch.configs.llama3_405b", "repro_torch.models.encdec",
                 "repro_torch.configs.qwen2_moe_a2_7b", "repro_torch.configs.phi3_5_moe",
                 "repro_torch.configs.llava_next_mistral_7b",
                 "repro_torch.configs.whisper_medium", "repro_torch.runtime",
                 "repro_torch.runtime.wire", "repro_torch.runtime.faults",
                 "repro_torch.runtime.server", "repro_torch.serve.datatier",
                 "repro_torch.runtime.launcher", "repro_torch.obs.log",
                 "repro_torch.obs.metrics", "repro_torch.obs.report",
                 "repro_torch.serve.tenant_load"):
        assert name in report["imported"]


_RANK_PROBE = """
import json, sys
import repro_torch.runtime.launcher, repro_torch.data.pipeline
import repro_torch.serve.datatier, repro_torch.obs.report
import repro_torch.serve.tenant_load
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("torch", "jax", "jaxlib", "repro"))))
"""


def test_launcher_ranks_import_no_torch():
    """What a launcher rank (and a tenant load process) imports — the
    launcher, the loader, the data tier, obs — pulls in neither torch nor
    JAX nor the JAX package: the ranks hold no tensors."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _RANK_PROBE], env=env, text=True,
                         capture_output=True, timeout=120, check=True)
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


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
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["train", "--arch", "qwen2-0.5b", "--reduced", "--steps", "1"])
    # asked for explicitly, the CPU works
    out = ServeEngine(cfg, params, max_len=16, device="cpu").generate(
        np.zeros((1, 4), np.int32), 2)
    assert out.shape == (1, 2)


def test_other_families_are_not_ported_yet():
    """Every family the JAX package runs is ported; a family it does not
    know still raises."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config("qwen2-0.5b").reduced().replace(family="bogus")
    with pytest.raises(NotImplementedError, match="bogus"):
        lm.init_lm(cfg, device="cpu")

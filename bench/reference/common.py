"""What the reference's modules share: float32 without TF32, the rounding
that puts the reference in a lower precision (the control), and the
reference's AdamW."""
from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["exact_f32", "Rounding", "AdamW", "leaf_norms"]


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN inside the
    block, and the flags as they were after it."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        # 10 mantissa bits, to nearest even: the low 13 bits of a float32
        bits = x.float().view(torch.int32).to(torch.int64)
        bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.to(torch.int32).view(torch.float32).to(x.dtype)
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(x.dtype)
    if precision == "fp8":
        # e4m3 with one scale per tensor, its largest magnitude at 448
        scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
        return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale)
    raise ValueError(f"unknown rounding {precision!r}")


class _RoundThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, precision):
        ctx.precision = precision
        return _round(x, precision)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.precision), None


class Rounding:
    """Rounds the operands of every product to ``precision`` (``tf32``,
    ``bfloat16``, ``fp8``) and its result to bfloat16 (TF32's stays
    float32), as a product on the tensor cores in that precision would
    (None: float32, nothing rounded).  The gradient flowing back through a
    rounded value is rounded the same way, as a low-precision backward's
    products would see it."""

    def __init__(self, precision: str | None = None):
        self.precision = precision

    def __call__(self, x: torch.Tensor, precision: str | None = None) -> torch.Tensor:
        if self.precision is None:
            return x
        return _RoundThrough.apply(x, precision or self.precision)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation the configuration keeps in bfloat16: rounded to it
        in a bfloat16 or fp8 control, left as it is in the reference (and
        under TF32, whose products write float32)."""
        return x if self.precision in (None, "tf32") else self(x, "bfloat16")

    def _result(self, x):
        # TF32 products write float32; the others' results are bfloat16
        return x if self.precision == "tf32" else self(x, "bfloat16")

    def mm(self, a, b):
        return self._result(self(a) @ self(b))

    def einsum(self, eq, *ops):
        return self._result(torch.einsum(eq, *[self(o) for o in ops]))


class AdamW:
    """AdamW with global-norm clipping, linear warmup and cosine decay,
    decoupled weight decay on every leaf, f32 moments; parameters are held
    as f32 tensors rounded to each leaf's storage dtype (``dtypes``) after
    each update.  Settings come from the configuration file's ``optimizer``
    block."""

    def __init__(self, params: dict, opt: dict, dtypes: dict):
        self.opt = opt
        self.dtypes = dtypes
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.step = 0

    def lr(self, step: int) -> float:
        o = self.opt
        warm = min(step / max(o["warmup_steps"], 1), 1.0)
        prog = min(max((step - o["warmup_steps"])
                       / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
        return o["lr"] * warm * 0.5 * (1.0 + math.cos(math.pi * prog))

    def clip_scale(self, grads: dict) -> float:
        gnorm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
        return min(self.opt["clip_norm"] / max(gnorm, 1e-9), 1.0)

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> float:
        """One step in place; returns the clip scale it applied."""
        o = self.opt
        self.step += 1
        lr = self.lr(self.step)
        scale = self.clip_scale(grads)
        b1c = 1.0 - o["b1"] ** self.step
        b2c = 1.0 - o["b2"] ** self.step
        for k, p in params.items():
            g = grads[k] * scale
            self.mu[k].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            self.nu[k].mul_(o["b2"]).add_(g.square(), alpha=1 - o["b2"])
            upd = (self.mu[k] / b1c) / ((self.nu[k] / b2c).sqrt() + o["eps"])
            upd = (upd + o["weight_decay"] * p) * lr
            p.copy_((p - upd).to(self.dtypes[k]).to(p.dtype))
        return scale


def leaf_norms(tree: dict) -> dict:
    """Each leaf's L2 norm as a float (in float64)."""
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}

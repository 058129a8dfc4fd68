"""Mamba-1's selective scan in plain PyTorch, float32, with its gradient.

    h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t,    y_t = C_t . h_t + D u_t

(Gu and Dao 2023, arXiv:2312.00752, Algorithm 2; A is [DI, N] and real.)
The recurrence h_t = a_t h_{t-1} + b_t runs as a Hillis-Steele scan inside
chunks of ``CHUNK`` steps, all chunks at once, and then carries each chunk's
last state into the next, in order.  The backward is the same recurrence
run from the end (g_t = dL/dh_t = C_t dy_t + a_{t+1} g_{t+1}) and the chain
rule through a = exp(dt A) and b = dt u B; it is checked against autograd
through a step-by-step loop in ``bench/test_bench_reference.py``.  One
row at a time: u, dt [S, DI], B, C [S, N], A [DI, N], D [DI]."""
from __future__ import annotations

import torch

__all__ = ["selective_scan", "linear_scan"]

CHUNK = 32


def linear_scan(a: torch.Tensor, b: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over dim 0 from h_{-1} = 0; a, b [S, ...].
    Overwrites neither input."""
    s = a.shape[0]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:  # steps past S carry a = 1, b = 0 and change nothing before S
        a = torch.cat([a, a.new_ones((pad,) + a.shape[1:])])
        b = torch.cat([b, b.new_zeros((pad,) + b.shape[1:])])
    c = a.shape[0] // q
    a = a.reshape((c, q) + a.shape[1:]).clone()
    h = b.reshape((c, q) + b.shape[1:]).clone()
    off = 1
    while off < q:  # inclusive scan inside every chunk: (a, h) . (a', h')
        h_new = torch.addcmul(h[:, off:], a[:, off:], h[:, :-off])
        a_new = a[:, off:] * a[:, :-off]
        h[:, off:] = h_new
        a[:, off:] = a_new
        del h_new, a_new
        off *= 2
    # carry the state entering each chunk: the previous chunk's last state
    carry = torch.empty_like(h[:, 0])
    carry[0] = 0
    for i in range(1, c):
        carry[i] = torch.addcmul(h[i - 1, -1], a[i - 1, -1], carry[i - 1])
    h.addcmul_(a, carry[:, None])
    return h.reshape((c * q,) + h.shape[2:])[:s]


class _SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, dt, a_mat, b, c, d):
        decay = torch.exp(dt[:, :, None] * a_mat)                     # [S, DI, N]
        inp = (dt * u)[:, :, None] * b[:, None, :]
        h = linear_scan(decay, inp)
        del decay, inp
        y = torch.einsum("sdn,sn->sd", h, c) + u * d
        ctx.save_for_backward(u, dt, a_mat, b, c, d, h)
        return y

    @staticmethod
    def backward(ctx, dy):
        u, dt, a_mat, b, c, d, h = ctx.saved_tensors
        decay = torch.exp(dt[:, :, None] * a_mat)
        # g_t = C_t dy_t + a_{t+1} g_{t+1}: the recurrence from the end
        nxt = torch.cat([decay[1:], decay.new_zeros((1,) + decay.shape[1:])])
        direct = dy[:, :, None] * c[:, None, :]
        g = linear_scan(nxt.flip(0), direct.flip(0)).flip(0)
        del nxt, direct
        h_prev = torch.cat([h.new_zeros((1,) + h.shape[1:]), h[:-1]])
        d_decay = g * h_prev * decay                                  # dL/d(dt A)
        del h_prev, decay
        gb = torch.einsum("sdn,sn->sd", g, b)
        d_dt = torch.einsum("sdn,dn->sd", d_decay, a_mat) + u * gb
        d_a = torch.einsum("sdn,sd->dn", d_decay, dt)
        del d_decay
        d_u = dt * gb + dy * d
        d_b = torch.einsum("sdn,sd->sn", g, dt * u)
        d_c = torch.einsum("sdn,sd->sn", h, dy)
        d_d = (dy * u).sum(0)
        return d_u, d_dt, d_a, d_b, d_c, d_d


def selective_scan(u, dt, a_mat, b, c, d):
    """y [S, DI] of one row (all float32)."""
    return _SelectiveScan.apply(u, dt, a_mat, b, c, d)

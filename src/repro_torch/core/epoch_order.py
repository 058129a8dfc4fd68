"""Epoch-order optimization (SOLAR §4.2.1).

Reordering the *epochs* changes how much of the buffer surviving at the end of
epoch ``u`` is reusable at the start of epoch ``v``.  The paper abstracts this
as a minimum-weight Hamiltonian *path* over a complete directed graph whose
vertices are epochs and whose edge weight is

    N(u, v) = card( firstBuffer(v)  −  lastBuffer(u) )

i.e. the number of samples epoch ``v`` needs early that epoch ``u`` does not
leave behind.  This is path-TSP (NP-complete); the paper solves it with
Particle Swarm Optimization.  We implement:

  * :func:`reuse_cost_matrix` — the N(u, v) matrix from the pre-determined
    shuffle (vectorized; O(E² · |Buffer|) set ops in numpy).
  * :func:`solve_pso` — the paper-faithful discrete PSO (swap-sequence
    velocity formulation, Shi et al. 2007).
  * :func:`solve_greedy_2opt` — beyond-paper: nearest-neighbor construction +
    Or-opt/2-opt local search.  Dominates PSO on every instance we measured
    (see EXPERIMENTS.md) while being deterministic.
  * :func:`solve_exact` — Held-Karp DP for E ≤ 14, used as the test oracle.

All solvers return (order, cost) where ``order`` is a permutation of epoch ids
and ``cost = sum_i N(order[i], order[i+1])``.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "reuse_cost_matrix",
    "path_cost",
    "solve_pso",
    "solve_greedy_2opt",
    "solve_exact",
    "optimize_epoch_order",
]


def reuse_cost_matrix(perms: np.ndarray, buffer_size: int) -> np.ndarray:
    """N[u, v] = |firstBuffer(v) − lastBuffer(u)| for every epoch pair.

    ``lastBuffer(u)``  = the last ``buffer_size`` *distinct* samples accessed in
    epoch u — what a capacity-``buffer_size`` buffer retains at epoch end.
    ``firstBuffer(v)`` = the first ``buffer_size`` samples epoch v touches.
    Within one epoch every sample occurs exactly once, so slicing suffices.
    """
    num_epochs, num_samples = perms.shape
    b = min(buffer_size, num_samples)
    # Membership bitmaps: [E, D] booleans.
    last = np.zeros((num_epochs, num_samples), dtype=bool)
    first = np.zeros((num_epochs, num_samples), dtype=bool)
    rows = np.arange(num_epochs)[:, None]
    last[rows, perms[:, num_samples - b :]] = True
    first[rows, perms[:, :b]] = True
    # N[u, v] = popcount(first[v] & ~last[u]).
    # Compute as  b - overlap(u, v)  with one [E, D] x [D, E] matmul.
    overlap = last.astype(np.int32) @ first.astype(np.int32).T  # [u, v]
    n = b - overlap
    np.fill_diagonal(n, 0)
    return n.astype(np.int64)


def path_cost(weights: np.ndarray, order: np.ndarray) -> int:
    return int(weights[order[:-1], order[1:]].sum())


# ---------------------------------------------------------------------------
# Paper-faithful solver: discrete PSO with swap-sequence velocities.
# ---------------------------------------------------------------------------


def _swap_sequence(src: np.ndarray, dst: np.ndarray) -> list[tuple[int, int]]:
    """Minimal swap list transforming ``src`` into ``dst`` (both permutations)."""
    src = src.copy()
    pos = np.empty_like(src)
    pos[src] = np.arange(src.size)
    swaps = []
    for i in range(src.size):
        if src[i] != dst[i]:
            j = pos[dst[i]]
            swaps.append((i, int(j)))
            pos[src[i]], pos[src[j]] = j, i
            src[i], src[j] = src[j], src[i]
    return swaps


def solve_pso(
    weights: np.ndarray,
    num_particles: int = 32,
    iterations: int = 200,
    seed: int = 0,
    w_inertia: float = 0.2,
    c_pbest: float = 0.6,
    c_gbest: float = 0.8,
) -> tuple[np.ndarray, int]:
    """Discrete PSO for path-TSP (the paper's §4.2.1 implementation choice).

    Each particle is a permutation; its velocity is a swap sequence.  The
    position update applies (probabilistically thinned) swap sequences toward
    the particle's personal best and the global best.
    """
    num_epochs = weights.shape[0]
    rng = np.random.Generator(np.random.PCG64(seed))
    particles = [rng.permutation(num_epochs) for _ in range(num_particles)]
    velocities: list[list[tuple[int, int]]] = [[] for _ in range(num_particles)]
    pbest = [p.copy() for p in particles]
    pbest_cost = [path_cost(weights, p) for p in particles]
    g = int(np.argmin(pbest_cost))
    gbest, gbest_cost = pbest[g].copy(), pbest_cost[g]

    for _ in range(iterations):
        for k in range(num_particles):
            x = particles[k]
            vel = [s for s in velocities[k] if rng.random() < w_inertia]
            vel += [s for s in _swap_sequence(x, pbest[k]) if rng.random() < c_pbest]
            vel += [s for s in _swap_sequence(x, gbest) if rng.random() < c_gbest]
            for i, j in vel:
                x[i], x[j] = x[j], x[i]
            velocities[k] = vel
            c = path_cost(weights, x)
            if c < pbest_cost[k]:
                pbest[k], pbest_cost[k] = x.copy(), c
                if c < gbest_cost:
                    gbest, gbest_cost = x.copy(), c
    return gbest, int(gbest_cost)


# ---------------------------------------------------------------------------
# Beyond-paper solver: greedy nearest-neighbor + Or-opt/2-opt local search.
# ---------------------------------------------------------------------------


def solve_greedy_2opt(
    weights: np.ndarray, max_rounds: int = 50
) -> tuple[np.ndarray, int]:
    """Deterministic NN construction + first-improvement local search.

    Moves used: 2-opt segment reversal (re-evaluated under the asymmetric
    matrix, not delta-computed) and Or-opt single-vertex relocation.  For the
    epoch counts that matter (E ≤ a few hundred) this is milliseconds and in
    our measurements always at least matches PSO (EXPERIMENTS.md §Benchmarks).
    """
    num_epochs = weights.shape[0]
    best_order, best_cost = None, None
    # NN from every start is cheap (O(E^3) worst case, E is small).
    starts = range(num_epochs) if num_epochs <= 128 else range(0, num_epochs, 4)
    for start in starts:
        unvisited = np.ones(num_epochs, dtype=bool)
        unvisited[start] = False
        order = [start]
        cur = start
        for _ in range(num_epochs - 1):
            row = np.where(unvisited, weights[cur], np.iinfo(np.int64).max)
            nxt = int(np.argmin(row))
            order.append(nxt)
            unvisited[nxt] = False
            cur = nxt
        order = np.asarray(order)
        cost = path_cost(weights, order)
        if best_cost is None or cost < best_cost:
            best_order, best_cost = order, cost

    order, cost = best_order.copy(), best_cost
    for _ in range(max_rounds):
        improved = False
        # 2-opt: reverse order[i:j].
        for i in range(num_epochs - 1):
            for j in range(i + 2, num_epochs + 1):
                cand = order.copy()
                cand[i:j] = cand[i:j][::-1]
                c = path_cost(weights, cand)
                if c < cost:
                    order, cost, improved = cand, c, True
        # Or-opt: relocate a single vertex.
        for i in range(num_epochs):
            for j in range(num_epochs):
                if i == j:
                    continue
                cand = np.delete(order, i)
                cand = np.insert(cand, j, order[i])
                c = path_cost(weights, cand)
                if c < cost:
                    order, cost, improved = cand, c, True
        if not improved:
            break
    return order, int(cost)


def solve_exact(weights: np.ndarray) -> tuple[np.ndarray, int]:
    """Held-Karp DP over subsets — oracle for tests (E ≤ 14)."""
    n = weights.shape[0]
    if n > 14:
        raise ValueError("exact solver limited to 14 epochs")
    full = 1 << n
    INF = np.iinfo(np.int64).max // 4
    dp = np.full((full, n), INF, dtype=np.int64)
    parent = np.full((full, n), -1, dtype=np.int32)
    for v in range(n):
        dp[1 << v, v] = 0
    for mask in range(full):
        for last in range(n):
            if dp[mask, last] >= INF or not mask & (1 << last):
                continue
            base = dp[mask, last]
            for nxt in range(n):
                if mask & (1 << nxt):
                    continue
                m2 = mask | (1 << nxt)
                c = base + weights[last, nxt]
                if c < dp[m2, nxt]:
                    dp[m2, nxt] = c
                    parent[m2, nxt] = last
    end = int(np.argmin(dp[full - 1]))
    cost = int(dp[full - 1, end])
    order = [end]
    mask = full - 1
    while parent[mask, order[-1]] >= 0:
        p = int(parent[mask, order[-1]])
        mask ^= 1 << order[-1]
        order.append(p)
    return np.asarray(order[::-1]), cost


def optimize_epoch_order(
    perms: np.ndarray,
    buffer_size: int,
    method: str = "greedy2opt",
    seed: int = 0,
) -> tuple[np.ndarray, int, int]:
    """Optimize the training epoch order; returns (order, cost, identity_cost).

    ``identity_cost`` is the cost of the natural order 0..E-1, i.e. what
    training pays without EOO — the benchmarks report the ratio.
    """
    weights = reuse_cost_matrix(perms, buffer_size)
    identity = np.arange(perms.shape[0])
    id_cost = path_cost(weights, identity)
    if method == "pso":
        order, cost = solve_pso(weights, seed=seed)
    elif method == "greedy2opt":
        order, cost = solve_greedy_2opt(weights)
    elif method == "exact":
        order, cost = solve_exact(weights)
    elif method == "none":
        order, cost = identity, id_cost
    else:
        raise ValueError(f"unknown epoch-order method {method!r}")
    return order, cost, id_cost

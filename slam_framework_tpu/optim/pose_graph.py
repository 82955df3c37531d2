"""Sim3 essential-graph (pose-graph) optimization — batched Gauss-Newton in JAX.

Replacement for Optimizer::OptimizeEssentialGraph (reference:
src/optimizer/optimizer.cpp:718-960), which runs g2o LM over VertexSim3Expmap
vertices connected by EdgeSim3 edges (spanning tree, covisibility >= 100 shared
points, and loop edges) after a loop closure.

Design (dense fixed-shape JAX, not a g2o translation):
  - Vertices are Sim3 world->camera transforms stored as struct-of-arrays
    (R: (V,3,3), t: (V,3), s: (V,)) with a validity mask; fixed vertices (the loop
    keyframe) are masked out of the update.
  - Edges are a flat COO table (i, j, measurement S_ji, mask). The residual of an
    edge is r = log(S_ji ∘ S_iw ∘ S_jw^-1) ∈ R^7, zero when the relative pose
    matches the measurement.
  - One Gauss-Newton step: per-edge 7x7 Jacobians w.r.t. the left-multiplicative
    tangent updates of both endpoints via forward-mode autodiff (vmap'd jacfwd —
    XLA fuses the 14-column pushforward into one batched program), then a
    matrix-free preconditioned CG on the normal equations: the Hessian-vector
    product is two gathers + two scatter-adds over the edge table, so cost is
    O(E) per CG iteration and never materializes the (7V, 7V) system. Block-Jacobi
    (7x7 per-vertex blocks) preconditioning.
  - Fixed iteration counts (lax.scan/fori_loop) — no data-dependent control flow.

All math runs in f32; the reference uses f64 g2o but pose graphs are
well-conditioned after Huber-free L2 (the reference also uses identity information
matrices, optimizer.cpp:783).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_framework_tpu.geometry import sim3
from slam_framework_tpu.utils.precision import einsum as _einsum


class PoseGraphProblem(NamedTuple):
    """Fixed-capacity Sim3 pose-graph. V vertex slots, E edge slots."""

    v_R: jnp.ndarray      # (V, 3, 3) rotation of S_iw
    v_t: jnp.ndarray      # (V, 3)
    v_s: jnp.ndarray      # (V,)
    v_fixed: jnp.ndarray  # (V,) bool — not updated (loop keyframe / invalid slots)
    v_mask: jnp.ndarray   # (V,) bool — valid vertex
    e_i: jnp.ndarray      # (E,) int32 — "from" vertex
    e_j: jnp.ndarray      # (E,) int32 — "to" vertex
    e_R: jnp.ndarray      # (E, 3, 3) measurement S_ji = S_jw ∘ S_iw^-1
    e_t: jnp.ndarray      # (E, 3)
    e_s: jnp.ndarray      # (E,)
    e_mask: jnp.ndarray   # (E,) bool
    e_weight: jnp.ndarray # (E,) f32 — information scale (1.0 = reference behavior)


class PoseGraphResult(NamedTuple):
    v_R: jnp.ndarray
    v_t: jnp.ndarray
    v_s: jnp.ndarray
    final_cost: jnp.ndarray


def _edge_residual(delta_i, delta_j, Si, Sj, Sji):
    """r = log(S_ji ∘ exp(δi)·S_iw ∘ (exp(δj)·S_jw)^-1) ∈ R^7."""
    Si2 = sim3.compose(sim3.exp(delta_i), Si)
    Sj2 = sim3.compose(sim3.exp(delta_j), Sj)
    rel = sim3.compose(Sji, sim3.compose(Si2, sim3.inverse(Sj2)))
    return sim3.log(rel)


def _edge_res_jac(Si, Sj, Sji):
    """Residual at δ=0 plus Jacobians (7,7)x2 w.r.t. both endpoint tangents."""
    z7 = jnp.zeros(7, jnp.float32)
    r = _edge_residual(z7, z7, Si, Sj, Sji)
    Ji = jax.jacfwd(_edge_residual, argnums=0)(z7, z7, Si, Sj, Sji)
    Jj = jax.jacfwd(_edge_residual, argnums=1)(z7, z7, Si, Sj, Sji)
    return r, Ji, Jj


def _pcg_block(hvp, g, Minv, iters: int):
    """CG with block-diagonal preconditioner. g, x: (V, 7); Minv: (V, 7, 7)."""

    def prec(r):
        return _einsum("vij,vj->vi", Minv, r)

    def dot(a, b):
        return jnp.sum(a * b)

    x0 = jnp.zeros_like(g)
    r0 = g
    z0 = prec(r0)

    def body(i, st):
        x, r, z, p, rz = st
        Ap = hvp(p)
        alpha = rz / jnp.maximum(dot(p, Ap), 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-20)
        return (x, r, z, z + beta * p, rz_new)

    x, *_ = jax.lax.fori_loop(0, iters, body, (x0, r0, z0, z0, dot(r0, z0)))
    return x


def _inv7x7_psd(M: jnp.ndarray) -> jnp.ndarray:
    """Batched inverse of damped SPD 7x7 blocks (small enough for jnp.linalg.inv)."""
    return jnp.linalg.inv(M + 1e-6 * jnp.eye(7, dtype=M.dtype))


@functools.partial(jax.jit, static_argnames=("iters", "cg_iters", "axis_name"))
def optimize(prob: PoseGraphProblem, iters: int = 20, cg_iters: int = 60,
             damping: float = 1e-6, axis_name: str | None = None) -> PoseGraphResult:
    """Gauss-Newton over the Sim3 pose graph (optimizer.cpp:718-960 equivalent:
    20 LM iterations with identity information; here GN + tiny damping since the
    problem is a well-posed graph anchored by the fixed loop keyframe).

    axis_name: when set, the caller runs this inside jax.shard_map with the EDGE
    table sharded over that mesh axis and the vertex state replicated; every
    edge-indexed reduction (gradient scatter, block-diagonal, Hessian-vector
    product, cost) is psum'd so each device holds the full replicated result —
    the same SPMD recipe as parallel/dist_ba.py (all-reduce payload is O(V·7)
    per CG iteration, across the device interconnect)."""
    V = prob.v_R.shape[0]
    free = (~prob.v_fixed) & prob.v_mask
    free_f = free.astype(jnp.float32)[:, None]  # (V, 1)
    ew = (prob.e_mask.astype(jnp.float32) * prob.e_weight)
    _allred = (
        (lambda x: jax.lax.psum(x, axis_name)) if axis_name else (lambda x: x)
    )

    def gn_step(state, _):
        R, t, s = state
        Sv = {"R": R, "t": t, "s": s}
        Si = jax.tree.map(lambda a: a[prob.e_i], Sv)
        Sj = jax.tree.map(lambda a: a[prob.e_j], Sv)
        Sji = {"R": prob.e_R, "t": prob.e_t, "s": prob.e_s}
        r, Ji, Jj = jax.vmap(_edge_res_jac)(Si, Sj, Sji)  # (E,7), (E,7,7), (E,7,7)
        r = r * ew[:, None]
        cost = _allred(jnp.sum(r * r))

        # gradient: g[v] = sum_e J^T r, scattered by endpoint
        gi = _einsum("eij,ei->ej", Ji, r)
        gj = _einsum("eij,ei->ej", Jj, r)
        g = _allred(
            jnp.zeros((V, 7)).at[prob.e_i].add(gi * ew[:, None]).at[prob.e_j].add(gj * ew[:, None])
        )
        g = g * free_f

        # block-diagonal of H for the preconditioner
        Hi = _einsum("eij,eik->ejk", Ji, Ji) * ew[:, None, None]
        Hj = _einsum("eij,eik->ejk", Jj, Jj) * ew[:, None, None]
        Hdiag = _allred(jnp.zeros((V, 7, 7)).at[prob.e_i].add(Hi).at[prob.e_j].add(Hj))
        Minv = _inv7x7_psd(Hdiag)

        def hvp(v):
            vi = v[prob.e_i]
            vj = v[prob.e_j]
            u = (_einsum("eij,ej->ei", Ji, vi)
                 + _einsum("eij,ej->ei", Jj, vj)) * ew[:, None]  # (E, 7)
            out = _allred(
                jnp.zeros((V, 7))
                .at[prob.e_i].add(_einsum("eij,ei->ej", Ji, u))
                .at[prob.e_j].add(_einsum("eij,ei->ej", Jj, u))
            )
            return out * free_f + damping * v

        dx = -_pcg_block(hvp, g, Minv, cg_iters) * free_f

        # apply left-multiplicative update; keep fixed vertices verbatim
        Snew = sim3.compose(sim3.exp(dx), Sv)
        keep = free[:, None, None]
        R2 = jnp.where(keep, Snew["R"], R)
        t2 = jnp.where(free[:, None], Snew["t"], t)
        s2 = jnp.where(free, Snew["s"], s)

        # accept only if cost decreased (cheap guard against a bad CG step)
        Si2 = jax.tree.map(lambda a: a[prob.e_i], {"R": R2, "t": t2, "s": s2})
        Sj2 = jax.tree.map(lambda a: a[prob.e_j], {"R": R2, "t": t2, "s": s2})
        rel2 = sim3.compose(Sji, sim3.compose(Si2, sim3.inverse(Sj2)))
        r2 = jax.vmap(sim3.log)(rel2) * ew[:, None]
        cost2 = _allred(jnp.sum(r2 * r2))
        # accept with a small RELATIVE tolerance: a strict `<` is chaotically
        # sensitive to f32 reduction-tree rounding — merely changing the edge
        # table's padded shape (exact-zero masked slots) altered the XLA sum
        # order enough to flip accepts and fork the whole trajectory onto a
        # different (equally valid) optimum. The tolerance makes the accept
        # decision invariant to padding/sharding shape.
        better = cost2 < cost * (1.0 + 1e-6)
        R = jnp.where(better, R2, R)
        t = jnp.where(better, t2, t)
        s = jnp.where(better, s2, s)
        return (R, t, s), jnp.where(better, cost2, cost)

    (R, t, s), costs = jax.lax.scan(
        gn_step, (prob.v_R, prob.v_t, prob.v_s), None, length=iters
    )
    return PoseGraphResult(v_R=R, v_t=t, v_s=s, final_cost=costs[-1])

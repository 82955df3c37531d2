"""Distributed Sim3 essential-graph optimization over a device mesh.

Reference equivalent: Optimizer::OptimizeEssentialGraph
(/root/reference/src/optimizer/optimizer.cpp:718-960) is single-threaded g2o;
SURVEY.md §5.8 mandates a multi-device story for every heavy optimizer. The
pose graph after a loop closure at city scale has 1e4-1e5 edges; per-edge
Jacobian construction (two 7x7 jacfwd pushforwards) dominates.

SPMD layout (same recipe as parallel/dist_ba.py):
  - EDGES are sharded over the mesh axis ('pg'); each device holds E/D edge
    slots (padded with masked slots to equal size).
  - VERTEX state (R, t, s, masks) is replicated; every edge-indexed reduction
    inside optim/pose_graph.optimize (gradient scatter, block-Jacobi diagonal,
    Hessian-vector product, cost) is psum'd via its axis_name hook, so each
    device steps the identical replicated vertex state.
  - All-reduce payload per CG iteration is one (V, 7) array.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from slam_framework_tpu.optim import pose_graph
from slam_framework_tpu.optim.pose_graph import PoseGraphProblem, PoseGraphResult
from slam_framework_tpu.parallel import multihost


def shard_problem(prob: PoseGraphProblem, n_shards: int) -> PoseGraphProblem:
    """Pad the edge table to a multiple of n_shards (round-robin deal of live
    edges balances Jacobian work) and return a problem whose edge arrays are
    the concatenation of equal-size shard blocks, ready for a ('pg',)-sharded
    NamedSharding on axis 0. Vertex arrays pass through (replicated)."""
    e_mask = np.asarray(prob.e_mask)
    live = np.nonzero(e_mask)[0]
    D = n_shards
    per = max(int(np.ceil(len(live) / D)), 1)
    E_s = D * per

    def deal(src, fill):
        out = np.full((E_s,) + src.shape[1:], fill, src.dtype)
        # edge at live-rank r -> shard r % D, local slot r // D
        ranks = np.arange(len(live))
        out[(ranks % D) * per + ranks // D] = src[live]
        return out

    # pad slots carry IDENTITY rotations (the convention the loop closer's own
    # padded edge tables use) — a zero 3x3 is not a rotation and sim3.log of it
    # is only accidentally finite; masked or not, keep pads on the manifold
    e_R_pad = deal(np.asarray(prob.e_R), 0.0)
    ranks = np.arange(len(live))
    filled = np.zeros(E_s, bool)
    filled[(ranks % D) * per + ranks // D] = True
    e_R_pad[~filled] = np.eye(3, dtype=e_R_pad.dtype)

    return PoseGraphProblem(
        v_R=prob.v_R, v_t=prob.v_t, v_s=prob.v_s,
        v_fixed=prob.v_fixed, v_mask=prob.v_mask,
        e_i=jnp.asarray(deal(np.asarray(prob.e_i), 0)),
        e_j=jnp.asarray(deal(np.asarray(prob.e_j), 0)),
        e_R=jnp.asarray(e_R_pad),
        e_t=jnp.asarray(deal(np.asarray(prob.e_t), 0.0)),
        e_s=jnp.asarray(deal(np.asarray(prob.e_s), 1.0)),
        e_mask=jnp.asarray(deal(e_mask, False)),
        e_weight=jnp.asarray(deal(np.asarray(prob.e_weight), 0.0)),
    )


def optimize_sharded(
    sharded: PoseGraphProblem,
    mesh: Mesh,
    iters: int = 20,
    cg_iters: int = 60,
    damping: float = 1e-6,
) -> PoseGraphResult:
    """Run pose_graph.optimize as one SPMD program over `mesh` (axis 'pg')."""
    axis = mesh.axis_names[0]
    edge_spec = P(axis)
    rep = P()
    in_specs = PoseGraphProblem(
        v_R=rep, v_t=rep, v_s=rep, v_fixed=rep, v_mask=rep,
        e_i=edge_spec, e_j=edge_spec, e_R=edge_spec, e_t=edge_spec,
        e_s=edge_spec, e_mask=edge_spec, e_weight=edge_spec,
    )
    out_specs = PoseGraphResult(v_R=rep, v_t=rep, v_s=rep, final_cost=rep)

    def body(p):
        # NOTE: a functools.partial here breaks under jit+shard_map (the bound
        # keywords are flattened as traced operands); use a closure instead.
        return pose_graph.optimize(
            p, iters=iters, cg_iters=cg_iters, damping=damping, axis_name=axis
        )
    fn = jax.jit(
        jax.shard_map(body, mesh=mesh, in_specs=(in_specs,), out_specs=out_specs)
    )
    # lay the edge blocks onto devices; a mesh spanning processes needs GLOBAL
    # arrays (each process contributes its addressable shards)
    ns_edge = NamedSharding(mesh, edge_spec)
    ns_rep = NamedSharding(mesh, rep)
    put = multihost.place if multihost.is_multiprocess(mesh) else jax.device_put
    placed = PoseGraphProblem(*[
        put(a, ns_edge if spec is edge_spec else ns_rep)
        for a, spec in zip(sharded, in_specs)
    ])
    return fn(placed)

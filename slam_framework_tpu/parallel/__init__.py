"""Multi-chip parallel layer: mesh partitioning + collective solvers.

Replacement for the reference's intra-process thread/mutex fabric
(SURVEY.md §2.3, §5.8): the map's point/observation tensors shard over a
jax.sharding.Mesh and camera-space reductions are collectives across devices.
"""

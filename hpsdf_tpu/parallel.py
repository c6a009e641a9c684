"""Multi-chip sharding: device meshes, sharded queries/traces, and a sharded
differentiable training step over the coefficient field.

The reference's entire parallel runtime is two std::thread pools plus OpenMP
inside Eigen's CG (SURVEY.md section 2, C9/C10); there is no distributed
backend to translate. This module is the from-scratch multi-device scaling
design (SURVEY.md sections 5.7/5.8):

  * **batch axis** ("dp"): query points / rays / pixels are embarrassingly
    parallel -- shard them across chips, tree replicated. This replaces the
    reference's per-thread scratch indexing (Include/HP/Octree.h:50,
    Include/Meshing/BVH.h:61-68).
  * **node axis** ("tp"): the flat SoA node arrays (and their coefficient
    rows) shard across chips for memory capacity; descent gathers become XLA
    collectives between devices.
  * gradient aggregation: the coefficient cotangent from a sharded loss is a
    psum over the batch axis -- XLA inserts it from the sharding annotations;
    no hand-written collectives.

Everything goes through ``jax.sharding.NamedSharding`` + jit ``in_shardings``
so the same code runs single-chip (trivial mesh) or on any (batch, node)
mesh shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .query import query as _query_fn
from .tree import Octree

BATCH_AXIS = "batch"
NODE_AXIS = "node"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host bring-up: ``jax.distributed.initialize`` with env-var
    defaults (SURVEY.md section 5.8 -- the reference has no distributed
    backend; this is the from-scratch multi-host entry). After this,
    ``jax.devices()`` spans all hosts and ``make_mesh`` builds global
    meshes whose collectives span hosts. No-op when already initialized
    or when running single-process with no coordinator configured."""
    import os

    # NOT jax.process_count(): that initializes the XLA backend, after
    # which jax.distributed.initialize refuses to run
    if jax.distributed.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get(
        "HPSDF_COORDINATOR")
    if coordinator_address is None and num_processes is None:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh(devices=None, node_parallel: int = 1) -> Mesh:
    """Build a (batch, node) device mesh.

    ``node_parallel`` chips shard the node/coefficient arrays (model-parallel
    axis); the remainder shard the point/ray batch (data-parallel axis).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % node_parallel:
        raise ValueError(f"{n} devices not divisible by "
                         f"node_parallel={node_parallel}")
    arr = np.asarray(devices).reshape(n // node_parallel, node_parallel)
    return Mesh(arr, (BATCH_AXIS, NODE_AXIS))


def tree_sharding(mesh: Mesh, tree: Octree, shard_nodes: bool = False):
    """Octree-shaped pytree of NamedShardings for ``tree``'s array leaves.

    Replicated by default (the tree is small next to a production ray batch);
    ``shard_nodes=True`` splits the node dimension across the node axis --
    the capacity-scaling layout for very deep trees. Built by replacing the
    leaves of ``tree`` so the static metadata (treedef) matches exactly.

    Measured (round 4, tests/test_parallel.py::test_node_sharded_memory
    _scales, compile-time memory analysis at a synthetic 2.4M-node tree on
    an 8-device mesh): XLA lowers the descent's global-index gathers
    against node-sharded operands as LOCAL masked gathers + one all-reduce
    of the (batch, row)-sized gathered values per descent round -- NOT as
    an all-gather of the node arrays. Per-device argument bytes drop from
    268.5 MB (replicated) to 33.7 MB (1/8), temps stay batch-sized, so the
    layout genuinely scales capacity; the price is ~(depth+1) batch-sized
    all-reduces per query batch. The cards of one host are joined all to
    all, so the mesh shape follows the algorithm, not a topology.
    """
    row = P(NODE_AXIS) if shard_nodes else P()
    row2 = P(NODE_AXIS, None) if shard_nodes else P()
    return dataclasses.replace(
        tree,
        child_idx=NamedSharding(mesh, row),
        centre=NamedSharding(mesh, row2),
        depth=NamedSharding(mesh, row),
        degree=NamedSharding(mesh, row),
        coeffs=NamedSharding(mesh, row2))


def _shard_tree(tree: Octree, mesh: Mesh, shard_nodes: bool) -> Octree:
    sh = tree_sharding(mesh, tree, shard_nodes)
    return dataclasses.replace(
        tree,
        child_idx=jax.device_put(tree.child_idx, sh.child_idx),
        centre=jax.device_put(tree.centre, sh.centre),
        depth=jax.device_put(tree.depth, sh.depth),
        degree=jax.device_put(tree.degree, sh.degree),
        coeffs=jax.device_put(tree.coeffs, sh.coeffs))


def _pad_batch(x: np.ndarray, m: int):
    b = x.shape[0]
    pad = (-b) % m
    if pad:
        x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)
    return x, b


def shard_query(tree: Octree, pts, mesh: Mesh, shard_nodes: bool = False):
    """``query`` with points sharded over the mesh batch axis.

    The scaled equivalent of the reference's 8M-point benchmark loop
    (Source/Tests/HPBenchmarks.cpp:78-115) over all chips at once.
    """
    pts = np.asarray(pts)
    pts_p, b = _pad_batch(pts, mesh.shape[BATCH_AXIS])
    stree = _shard_tree(tree, mesh, shard_nodes)
    dpts = jax.device_put(pts_p, NamedSharding(mesh, P(BATCH_AXIS, None)))
    return _query_fn(stree, dpts)[:b]


def shard_trace(tree: Octree, origins, dirs, mesh: Mesh, t_max: float = 10.0,
                **kw):
    """Sphere-trace with rays sharded over the batch axis (tree replicated).

    Multi-chip generalization of render.trace -- the BASELINE "Mrays/s"
    scaling path.
    """
    from .accel import pack_tree
    from .render import TraceResult, trace as _trace
    origins = np.asarray(origins, np.float32)
    dirs = np.asarray(dirs, np.float32)
    o_p, b = _pad_batch(origins, mesh.shape[BATCH_AXIS])
    d_p, _ = _pad_batch(dirs, mesh.shape[BATCH_AXIS])
    stree = _shard_tree(tree, mesh, shard_nodes=False)
    rep = NamedSharding(mesh, P())
    packed = kw.pop("packed", None) or pack_tree(tree)
    packed = dataclasses.replace(
        packed, rows=jax.device_put(packed.rows, rep),
        grid=jax.device_put(packed.grid, rep))
    sh = NamedSharding(mesh, P(BATCH_AXIS, None))
    res = _trace(stree, jax.device_put(o_p, sh),
                 jax.device_put(d_p, sh), t_max=t_max, packed=packed, **kw)
    return TraceResult(res.t[:b], res.hit[:b], res.steps)


# --------------------------------------------------------------------------
# Sharded differentiable training step
# --------------------------------------------------------------------------
#
# The octree *is* the model and its coefficient array is the parameter
# tensor: train_step performs one SGD step on 0.5*mean((query - target)^2)
# w.r.t. the coefficients. Points shard over the batch axis (dp); node/coeff
# rows shard over the node axis (tp); XLA inserts the psum for the gradient
# all-reduce from the shardings. This is the differentiable-fitting
# counterpart of the reference's quadrature refit, and the payload of
# __graft_entry__.dryrun_multichip.

def loss_fn(coeffs, tree: Octree, pts, target):
    t = dataclasses.replace(tree, coeffs=coeffs)
    pred = _query_fn(t, pts, outside_value_max=False)
    return 0.5 * jnp.mean((pred - target) ** 2)


def train_step(tree: Octree, pts, target, lr):
    """One SGD step on the coefficient field. Returns (tree', loss)."""
    loss, g = jax.value_and_grad(loss_fn)(tree.coeffs, tree, pts, target)
    return dataclasses.replace(tree, coeffs=tree.coeffs - lr * g), loss


def make_sharded_train_step(mesh: Mesh, tree: Octree,
                            shard_nodes: bool = True):
    """jit ``train_step`` with explicit in/out shardings over ``mesh``.

    coeffs/node arrays: P(node, None); points/targets: P(batch, ...);
    loss: replicated scalar.
    """
    tree_sh = tree_sharding(mesh, tree, shard_nodes)
    pts_sh = NamedSharding(mesh, P(BATCH_AXIS, None))
    tgt_sh = NamedSharding(mesh, P(BATCH_AXIS))
    rep = NamedSharding(mesh, P())

    step = jax.jit(
        train_step,
        in_shardings=(tree_sh, pts_sh, tgt_sh, rep),
        out_shardings=(tree_sh, rep),
    )

    def run(tr: Octree, pts, target, lr=1e-3):
        tr = _shard_tree(tr, mesh, shard_nodes)
        pts = jax.device_put(jnp.asarray(pts), pts_sh)
        target = jax.device_put(jnp.asarray(target), tgt_sh)
        return step(tr, pts, target, jax.device_put(
            jnp.asarray(lr, pts.dtype), rep))

    return run

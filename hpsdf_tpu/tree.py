"""Flat SoA octree state.

The reference stores nodes in one ``std::vector<Node>`` with 8-block child
allocation and, post-``ReallocCoeffs``, all coefficients in a single
contiguous block addressed by offsets (reference: Include/HP/Node.h:21-29,
Source/HP/Octree.cpp:474-555). That layout maps directly onto device arrays;
here it *is* the representation:

  child_idx[N] : first-child index, -1 for leaves   (Node.h:14-15)
  centre[N,3]  : cell centre in the internal unit cube [-0.5, 0.5]^3
  depth[N]     : cell depth, cell size = 2**-depth  (Node.h:31)
  degree[N]    : basis total degree, -1 for interior nodes (the reference's
                 ``degree == BASIS_MAX_DEGREE+1`` sentinel, Node.cpp:7-14)
  coeffs[N,C]  : zero-padded coefficient rows, C = coeff_count(deg_used)

Zero-padding makes per-leaf degree irrelevant at evaluation time: summing the
full padded basis gives bit-identical results to the reference's
degree-truncated sum, so queries never branch on degree.

An ``Octree`` is a registered pytree -- it can be donated to jit, sharded
with jax.sharding, and checkpointed as flat arrays.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp

from . import consts
from .config import Config, NearnessWeighting


SERIAL_VERSION = 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Octree:
    # --- device arrays (pytree leaves) ---
    child_idx: jax.Array    # i32[N]
    centre: jax.Array       # f64[N, 3] internal unit-cube coords
    depth: jax.Array        # i32[N]
    degree: jax.Array       # i32[N]
    coeffs: jax.Array       # f64[N, C]

    # --- static metadata (aux data) ---
    n_nodes: int = dataclasses.field(metadata=dict(static=True))
    deg_used: int = dataclasses.field(metadata=dict(static=True))
    depth_used: int = dataclasses.field(metadata=dict(static=True))
    config: Config = dataclasses.field(metadata=dict(static=True))

    @property
    def capacity(self) -> int:
        return self.child_idx.shape[0]

    @property
    def coeff_width(self) -> int:
        return self.coeffs.shape[1]

    # World-space root AABB accessor (reference: Octree.h:80-81 GetRootAABB).
    @property
    def root_aabb(self) -> tuple[np.ndarray, np.ndarray]:
        return (np.asarray(self.config.root_min, np.float64),
                np.asarray(self.config.root_max, np.float64))

    def num_leaves(self) -> int:
        ci = np.asarray(self.child_idx[: self.n_nodes])
        return int(np.sum(ci < 0))

    def total_coeffs(self) -> int:
        """Sum of per-leaf true coefficient counts (as the reference's
        serialized nCoeffs, Source/HP/Octree.cpp:428-435)."""
        deg = np.asarray(self.degree[: self.n_nodes])
        leaves = deg >= 0
        return int(sum(consts.coeff_count(int(d)) for d in deg[leaves]))


def pack(child_idx: np.ndarray, centre: np.ndarray, depth: np.ndarray,
         degree: np.ndarray, coeffs: np.ndarray, n_nodes: int,
         config: Config, pad_to: int = 8) -> Octree:
    """Pack host build arrays into a device Octree.

    Trims the coefficient width to the maximum degree actually used, pads the
    node dimension to a multiple of ``pad_to`` (dummy rows are self-looping
    leaves with zero coeffs), and uploads to the default device.
    """
    n = int(n_nodes)
    deg_used = int(max(0, degree[:n].max(initial=0)))
    depth_used = int(depth[:n].max(initial=0))
    width = consts.coeff_count(deg_used)

    n_pad = -(-n // pad_to) * pad_to
    ci = np.full(n_pad, consts.NO_CHILD, np.int32)
    ce = np.zeros((n_pad, 3), np.float64)
    dp = np.zeros(n_pad, np.int32)
    dg = np.full(n_pad, consts.NO_BASIS, np.int32)
    co = np.zeros((n_pad, width), np.float64)

    ci[:n] = child_idx[:n]
    ce[:n] = centre[:n]
    dp[:n] = depth[:n]
    dg[:n] = degree[:n]
    co[:n] = coeffs[:n, :width]

    return Octree(
        child_idx=jnp.asarray(ci), centre=jnp.asarray(ce),
        depth=jnp.asarray(dp), degree=jnp.asarray(dg), coeffs=jnp.asarray(co),
        n_nodes=n, deg_used=deg_used, depth_used=depth_used, config=config)


# --------------------------------------------------------------------------
# Serialization -- versioned flat-array schema.
#
# Replaces the reference's raw-struct MemoryBlock round-trip
# (Source/HP/Octree.cpp:403-456), which is platform-dependent (SURVEY C1
# quirk); ours is an .npz with an explicit versioned JSON header.
# --------------------------------------------------------------------------

def save(tree: Octree, path: str) -> None:
    cfg = tree.config
    meta = dict(
        version=SERIAL_VERSION,
        n_nodes=tree.n_nodes, deg_used=tree.deg_used,
        depth_used=tree.depth_used,
        config=dict(
            target_error=cfg.target_error,
            nearness_weighting=cfg.nearness_weighting.value,
            nearness_strength=cfg.nearness_strength,
            continuity=cfg.continuity,
            continuity_strength=cfg.continuity_strength,
            root_min=list(cfg.root_min), root_max=list(cfg.root_max),
            max_degree=cfg.max_degree, max_depth=cfg.max_depth,
            node_capacity=cfg.node_capacity,
        ),
    )
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        child_idx=np.asarray(tree.child_idx),
        centre=np.asarray(tree.centre),
        depth=np.asarray(tree.depth),
        degree=np.asarray(tree.degree),
        coeffs=np.asarray(tree.coeffs),
    )


def load(path: str) -> Octree:
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["version"] != SERIAL_VERSION:
            raise ValueError(f"unsupported octree schema v{meta['version']}")
        c = meta["config"]
        cfg = Config(
            target_error=c["target_error"],
            nearness_weighting=NearnessWeighting(c["nearness_weighting"]),
            nearness_strength=c["nearness_strength"],
            continuity=c["continuity"],
            continuity_strength=c["continuity_strength"],
            root_min=tuple(c["root_min"]), root_max=tuple(c["root_max"]),
            max_degree=c["max_degree"], max_depth=c["max_depth"],
            node_capacity=c["node_capacity"],
        )
        return Octree(
            child_idx=jnp.asarray(z["child_idx"]),
            centre=jnp.asarray(z["centre"]),
            depth=jnp.asarray(z["depth"]),
            degree=jnp.asarray(z["degree"]),
            coeffs=jnp.asarray(z["coeffs"]),
            n_nodes=meta["n_nodes"], deg_used=meta["deg_used"],
            depth_used=meta["depth_used"], config=cfg)

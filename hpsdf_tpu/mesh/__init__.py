"""Mesh -> SDF pipeline (batched redesign of the reference's Meshing
namespace, SURVEY.md components C12-C16).

  obj.py   <- ObjParser           (Include/Meshing/ObjParser.h)
  core.py  <- Mesh (half-edges + pseudo-normals)  (Include/Meshing/Mesh.h)
  tri.py   <- triangle utilities  (Include/Meshing/Utility.h)
  bvh.py   <- BVH                 (Include/Meshing/BVH.h)
  nn.py    <- NNOctree            (Include/Meshing/NNOctree.h)
  sdf.py   <- batched signed-distance callables (the reference's
              Mesh::SignedDistanceAtPt + BVH::ClosestTriangleToPt read path)
  pallas_sdf.py <- Pallas (Triton) kernel: dense tiled points x
              triangles closest-distance scan (the exact O(T) oracle)

The read path is device-resident: triangles and BVH nodes are packed into
wide gather-friendly rows (see accel.py for the gather economics) and the
closest-triangle search runs as a batched stackless traversal inside jit,
so a mesh SDF can serve as the F callable of build_octree directly.
"""

from .obj import load_obj
from .core import TriMesh, build_mesh
from .bvh import BVH, build_bvh
from .sdf import (mesh_sdf, signed_distance, signed_distance_brute,
                  signed_distance_tiles)
from .nn import PointIndex

__all__ = [
    "load_obj", "TriMesh", "build_mesh", "BVH", "build_bvh",
    "mesh_sdf", "signed_distance", "signed_distance_brute",
    "signed_distance_tiles", "PointIndex",
]

"""hpsdf_tpu -- hp-adaptive signed-distance-field octree framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
jw007123/hp-Adaptive-Signed-Distance-Field-Octree (Koschier, Deul, Bender,
"An hp-Adaptive Discretization Algorithm for Signed Distance Field
Generation", TVCG 2017): batched hp-adaptive Legendre-basis octree fitting,
vectorized queries with analytic gradients, a global continuity solve,
CSG operators, mesh -> SDF conversion, and a differentiable sphere-tracing
renderer, all sharding-aware via jax.sharding meshes.
"""

import os

# The fit/continuity math is f64 (as in the reference); the render path uses
# explicit f32. Must run before any other jax usage.
if os.environ.get("HPSDF_NO_X64", "0") != "1":
    import jax

    jax.config.update("jax_enable_x64", True)

from .config import Config, NearnessWeighting            # noqa: E402
from .tree import Octree, save, load                     # noqa: E402
from .api import (build_octree, query, query_with_gradient, query_grid,
                  union_sdf, subtract_sdf, intersect_sdf)  # noqa: E402
from .accel import pack_tree  # noqa: E402
from . import df64  # noqa: E402
from .viz import output_function_slice, function_slice  # noqa: E402
from . import inverse  # noqa: E402
from .render import (trace, camera_rays, intersect_aabb,  # noqa: E402
                     render as render_image)
from . import render as _render_mod  # noqa: E402,F401

# keep ``hpsdf_tpu.render`` pointing at the submodule (the function is
# exported as ``render_image``)
render = _render_mod

__all__ = [
    "Config", "NearnessWeighting", "Octree", "save", "load",
    "build_octree", "query", "query_with_gradient", "query_grid",
    "union_sdf", "subtract_sdf", "intersect_sdf", "pack_tree",
    "trace", "render_image", "camera_rays", "intersect_aabb", "render",
    "output_function_slice", "function_slice", "inverse", "df64",
]
__version__ = "0.1.0"

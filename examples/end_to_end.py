"""End-to-end tour of hpsdf_tpu: mesh -> SDF -> hp-adaptive octree ->
queries / CSG / rendering / serialization.

Mirrors the reference library's intended usage (an SDF::Octree fitted over
Meshing::Mesh::SignedDistanceAtPt; see SURVEY.md section 3.4) plus the
capabilities the reference does not have: differentiable rendering and a
depth-target inverse step.

Run on the GPU:     python examples/end_to_end.py
Run on CPU:         JAX_PLATFORMS=cpu python examples/end_to_end.py
"""

import os
import time

import numpy as np
import jax
import jax.numpy as jnp

import hpsdf_tpu as hp
from hpsdf_tpu import compile_cache
from hpsdf_tpu import mesh as M
from hpsdf_tpu.mesh import gen

compile_cache.enable()
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
os.makedirs(OUT, exist_ok=True)
on_accel = jax.devices()[0].platform != "cpu"


def stamp(msg, t0):
    print(f"  {msg}: {time.perf_counter() - t0:.2f}s", flush=True)


# 1. Procedural mesh (stand-in for an .obj asset) -> half-edge mesh + BVH.
print("mesh -> signed-distance oracle")
t0 = time.perf_counter()
v, f = gen.icosphere(0.3, 5 if on_accel else 3)  # 20,480 / 1,280 triangles
mesh = M.build_mesh(v, f)                        # native C++ fast path
F = M.mesh_sdf(mesh)                             # method chosen by size
stamp(f"{mesh.n_faces} tris, watertight, pseudo-normals", t0)

# 2. Fit the hp-adaptive octree (Octree::Create equivalent). The CPU
# config is deliberately small: the fit evaluates F at ~1e6 quadrature
# points, interactive on the accelerator but minutes on a 2-vCPU host.
print("hp-adaptive fit")
t0 = time.perf_counter()
cfg = hp.Config(target_error=1e-5 if on_accel else 1e-4,
                max_depth=4, max_degree=4 if on_accel else 3,
                continuity=False, fit_dtype="float64")
tree = hp.build_octree(cfg, F)
stamp(f"{tree.n_nodes} nodes, deg<= {tree.deg_used}", t0)

# 3. Queries (Query / QueryWithGradient equivalents).
pts = jnp.asarray(np.random.default_rng(0).uniform(-0.4, 0.4, (10000, 3)))
vals = hp.query(tree, pts)
vals_g, grads = hp.query_with_gradient(tree, pts)
ref = jnp.linalg.norm(pts, axis=-1) - 0.3
print(f"  query max|err| vs analytic sphere: "
      f"{float(jnp.max(jnp.abs(vals - ref))):.2e}")

# 4. CSG rebuild: carve a box out of the sphere (tree MINUS box).
# Operand order matches the reference: subtract_sdf(tree, F) approximates
# max(-tree, F) = F minus tree (Octree::SubtractSDF, Octree.cpp:379-390);
# tree minus F is therefore intersect_sdf(tree, -F).
def box(p):
    q = jnp.abs(p) - 0.18
    return (jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
            + jnp.minimum(jnp.max(q, axis=-1), 0.0))

t0 = time.perf_counter()
carved = hp.intersect_sdf(tree, lambda p: -box(p))
stamp("CSG carve rebuild", t0)

# 5. Render (sphere tracing + analytic normals; no reference counterpart).
t0 = time.perf_counter()
img, depth, hit = hp.render_image(carved, eye=(0.5, 0.4, -1.6),
                                  look_at=(0.0, 0.0, 0.0),
                                  width=512, height=512, t_max=5.0)
jax.block_until_ready(img)
stamp(f"render 512^2, hit fraction {float(jnp.mean(hit)):.3f}", t0)

# 6. Artifacts: shaded image + field slice (OutputFunctionSlice equivalent).
from hpsdf_tpu.viz import write_bmp

write_bmp(os.path.join(OUT, "render.bmp"),
          np.asarray(jnp.clip(img, 0.0, 1.0) * 255).astype(np.uint8))
hp.output_function_slice(carved, os.path.join(OUT, "slice.bmp"), z=0.0,
                         resolution=512)
print(f"  wrote {OUT}/render.bmp and {OUT}/slice.bmp")

# 7. Serialization round trip (To/FromMemoryBlock equivalent).
path = os.path.join(OUT, "tree.npz")
hp.save(carved, path)
re = hp.load(path)
assert np.array_equal(np.asarray(re.coeffs), np.asarray(carved.coeffs))
print("  save/load round trip: bit-exact")

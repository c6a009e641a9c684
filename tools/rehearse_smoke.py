"""Rehearse chip_smoke.py on the CPU at tiny sizes, before a GPU run.

    JAX_PLATFORMS=cpu python tools/rehearse_smoke.py            # all phases
    JAX_PLATFORMS=cpu python tools/rehearse_smoke.py 1 mesh     # some phases
    JAX_PLATFORMS=cpu python tools/rehearse_smoke.py 4          # sharded phase

Finds wrong paths, arguments and control flow; says nothing about speed or
about what the GPU compiler accepts. The tile kernel runs in the Pallas
interpreter here. With 4, the sharded phase runs on 4 virtual CPU devices.
"""
import os
import sys

N_DEV = int(sys.argv[1]) if len(sys.argv) > 1 else 1
if N_DEV > 1:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={N_DEV}")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax                                              # noqa: E402

import chip_smoke as cs                                 # noqa: E402
import hpsdf_tpu as hp                                  # noqa: E402
from hpsdf_tpu.mesh import pallas_sdf                   # noqa: E402
from hpsdf_tpu.mesh import sdf as msdf                  # noqa: E402


def main():
    kernel = pallas_sdf.closest_tri_tiles
    msdf._pallas.closest_tri_tiles = (
        lambda t, p, interpret=False: kernel(t, p, interpret=True))
    jax.monitoring.register_event_duration_secs_listener(cs._on_duration)
    sz = cs.Sizes(query_pts=1 << 16, compare_pts=1 << 14, image=128,
                  mesh_subdiv=3, mesh_pts=4096, mesh_ref_pts=512,
                  ico_subdiv=2, inverse_wh=(64, 48))
    state = {}
    if N_DEV > 1:
        ok = cs.run_phase("sharded", cs.phase_sharded, sz, state, N_DEV)
    else:
        ok = True
        for name in sys.argv[2:] or ["fit", "continuity", "query", "trace",
                                     "mesh", "inverse"]:
            if name in ("query", "trace") and "tree" not in state:
                state["tree"] = hp.build_octree(
                    cs.refdefault_config(fit_dtype="float64"),
                    hp.df64.Sphere(cs.SPHERE_R, centre=cs.SPHERE_C))
            ok = cs.run_phase(name, getattr(cs, "phase_" + name), sz,
                              state) and ok
    print("rehearsal", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Geometry and sampling ops of the port (plain PyTorch + the CUDA kernels).

Each module that holds a kernel exposes a module-level ``launches``
counter; :func:`reset_launches` and :func:`launch_counts` read them all.
"""

from . import interp_mxu, knn, mesh_query, onehot_gather, rasterize

KERNEL_MODULES = {"mesh_query": mesh_query, "knn": knn,
                  "rasterize": rasterize, "interp_mxu": interp_mxu,
                  "onehot_scatter": onehot_gather}


def reset_launches() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}

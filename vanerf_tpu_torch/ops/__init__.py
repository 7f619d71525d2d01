"""Geometry and sampling ops of the port (plain PyTorch + the CUDA kernels).

Each kernel's wrapper adds one to a module-level counter where it launches
the kernel; :func:`reset_launches` and :func:`launch_counts` read them all.
"""

from . import (fused_mlp, grid_sample, interp_mxu, knn, mesh_query,
               onehot_gather, rasterize)
from .mesh_query import (  # noqa: F401
    barycentric_of_projection, cal_vis_sdf, point_mesh_sdf, winding_number)

# kernel name -> (module, counter attribute)
KERNEL_COUNTERS = {"mesh_query": (mesh_query, "launches"),
                   "knn": (knn, "launches"),
                   "mesh_query_brute": (mesh_query, "brute_launches"),
                   "mesh_query_vis_brute": (mesh_query,
                                            "vis_brute_launches"),
                   "mesh_query_T": (mesh_query, "launches_T"),
                   "knn_T": (knn, "launches_T"),
                   "knn_culled": (knn, "culled_launches"),
                   "knn_T_culled": (knn, "culled_launches_T"),
                   "rasterize": (rasterize, "launches"),
                   "interp_mxu": (interp_mxu, "launches"),
                   "onehot_scatter": (onehot_gather, "launches"),
                   "row_gather": (interp_mxu, "row_gather_launches"),
                   "fused_query_mlp": (fused_mlp, "query_launches"),
                   "fused_geo_mlp": (fused_mlp, "geo_launches"),
                   # the bfloat16 forms of D, 10, 11, 12 and 13
                   "interp_mxu_bf16": (interp_mxu, "launches_bf16"),
                   "row_gather_bf16": (interp_mxu,
                                       "row_gather_launches_bf16"),
                   "fused_query_mlp_bf16": (fused_mlp,
                                            "query_launches_bf16"),
                   "fused_geo_mlp_bf16": (fused_mlp, "geo_launches_bf16"),
                   # their bfloat16 body for widths other than BF16_DIMS
                   "fused_query_mlp_bf16_mma": (fused_mlp,
                                                "query_launches_bf16_mma"),
                   "fused_geo_mlp_bf16_mma": (fused_mlp,
                                              "geo_launches_bf16_mma"),
                   "onehot_scatter_bf16": (onehot_gather, "launches_bf16"),
                   # kernel 14, feat_sample_nhwc's sampler (both dtypes)
                   "bilinear": (grid_sample, "launches"),
                   "bilinear_bf16": (grid_sample, "launches_bf16")}


def reset_launches() -> None:
    for mod, attr in KERNEL_COUNTERS.values():
        setattr(mod, attr, 0)
    # the sweeps over every face kept beside kernels A and 7 (comparisons)
    mesh_query.unculled_launches = mesh_query.unculled_launches_T = 0


def launch_counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in KERNEL_COUNTERS.items()}

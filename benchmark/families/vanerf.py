"""The VANeRF family: the shipped configuration (``rel_z_decay``, float32,
one or more source views) as ``benchmark/reference/`` and
``benchmark/flops.py`` hold it."""

from benchmark import flops
from benchmark.reference import train
from benchmark.reference.nets import Generator
from benchmark.reference.render import render_frame

frame_flops = flops.frame
step_flops = flops.train_step

# the program's per-point networks: GeoVisFusion, MLPUNetFusion,
# TexVisFusion, IBRRenderingHead (network_ms.serve reads their forward)
NETWORK_MODULES = ("geo_vis_fusion", "mlp_geo", "tex_vis_fusion", "mlp_tex")

from .blocks import ConvBlock, HGFilter, HourGlass, ResBlkEncoder  # noqa: F401
from .fusion import GeoVisFusion, TexVisFusion  # noqa: F401
from .ibr import IBRRenderingHead  # noqa: F401
from .mlp import MLP, MLPUNet, MLPUNetFusion, WNLinear  # noqa: F401
from .spatial import SpatialEncoder  # noqa: F401
from .vanerf import VANeRF, init_like_flax  # noqa: F401
from .discriminator import DiscriminatorVis  # noqa: F401

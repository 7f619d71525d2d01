from .layer import (ManoModel, load_mano_model, load_mano_pair,  # noqa: F401
                    mano_forward, mano_forward_np, seal_verts_np)

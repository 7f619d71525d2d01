"""Model families: the reference side of a configuration, found by name.

A configuration names its family under a top-level ``"family"`` key of its
own file (``vanerf`` where it names none; the program ignores the key).
``benchmark/families/<name>.py`` exports what the harness holds that
configuration's program against:

- ``Generator(m, num_v, hw)``: the reference generator under the program's
  state-dict names; the seeded weights are drawn over its parameters on
  ``meta`` (``weights.seeded_state``);
- ``render_frame(G, req, *, level, n_c, n_f, n_views, far_tau)``: the
  reference frame a served request is checked against;
- ``train``: the reference training module (``Discriminator``, ``Vgg19``,
  ``Adam``, ``step``) whose first steps a training run is checked against;
- ``frame_flops(m, H, W, level, n_c, n_f, n_views)`` and
  ``step_flops(m, H, W, n_views)``: the model FLOPs of a frame and of a
  step, which the ``mfu`` readers divide by the peak;
- ``NETWORK_MODULES``: the program model's attributes whose forward the
  ``bench.network`` range wraps.

A new model brings a new file; nothing in the drivers names a family.
"""

from __future__ import annotations

import importlib.util
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEFAULT = "vanerf"        # a configuration that names no family
EXPORTS = ("Generator", "render_frame", "train", "frame_flops", "step_flops",
           "NETWORK_MODULES")


def load_family(name: str, root: pathlib.Path = ROOT):
    """The family module ``name`` under ``root``, with every export."""
    from ..manifest import ManifestError
    path = pathlib.Path(root) / "families" / f"{name}.py"
    if not path.is_file():
        raise ManifestError(f"family {name}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_family_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [k for k in EXPORTS if not hasattr(mod, k)]
    if missing:
        raise ManifestError(f"family {name}: lacks {', '.join(missing)}")
    return mod

"""Config system: JSON loader + CLI (port of ``vanerf_tpu/config.py``).

The port reads the same ``configs/*.json`` schema and takes the same CLI
flags (``--config --data_root --out_dir --run_val --in_the_wild
--fast_dev_run --model_ckpt --num_gpus --synthetic_data --profile_dir``),
plus ``--device``.  YAML configs (``.yml`` / ``.yaml``) are read as the
JAX package reads them, through the ``yaml`` package imported where a
YAML file is loaded; where it is not installed (the card's machine has
none) loading one raises ``ImportError`` with the way out.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pathlib
import subprocess

logger = logging.getLogger("vanerf_tpu_torch")


def create_parser() -> argparse.ArgumentParser:
    """CLI parser, flag-compatible with ``vanerf_tpu/config.py:25`` (the
    reference's ``src/config.py:11-51``)."""
    parser = argparse.ArgumentParser(description="Run VANeRF (CUDA).")
    parser.add_argument("--config", type=str, help="Configuration file")
    parser.add_argument("--data_root", type=str, required=False,
                        help="Data directory")
    parser.add_argument("--out_dir", type=str, default=None, required=False,
                        help="Overwrite the log directory from the config.")
    parser.add_argument("--run_val", action="store_true")
    parser.add_argument("--in_the_wild", action="store_true")
    parser.add_argument("--fast_dev_run", action="store_true")
    parser.add_argument("--model_ckpt", type=str, default=None)
    parser.add_argument("--num_gpus", default=1, type=int,
                        help="Number of devices (data-parallel ranks).")
    parser.add_argument("--synthetic_data", action="store_true",
                        help="Run on the built-in synthetic fixture dataset.")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="If set, write a torch.profiler Chrome trace "
                             "of fit here.")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Where the model runs (default: the card).")
    return parser


def resolve_flags(args) -> None:
    """Post-parse flag routing (mutates ``args``): ``--in_the_wild`` means
    ``--run_val``, as in the JAX package (the reference's own path is
    broken upstream, ``train.py:73``; PARITY.md)."""
    if getattr(args, "in_the_wild", False):
        logger.warning("--in_the_wild: reference code path is broken "
                       "upstream (train.py:73); treating as --run_val.")
        args.run_val = True


def load_cfg(path: str) -> dict:
    """Load a JSON or YAML config (reference ``src/config.py:54-68``;
    ``vanerf_tpu/config.py:62-70``)."""
    path = str(path)
    if path.endswith(".json"):
        with open(path, "r") as file:
            return json.load(file)
    if path.endswith((".yml", ".yaml")):
        try:
            import yaml
        except ImportError as e:
            raise ImportError(
                f"{path}: YAML configs need the 'yaml' package (PyYAML), "
                "which is not installed; pass the config as JSON") from e
        with open(path, "r") as file:
            return yaml.safe_load(file)
    raise ValueError(f"Invalid config file {path!r}: JSON (.json) or YAML "
                     "(.yml, .yaml)")


def save_config(dst_directory: str, config: dict) -> None:
    """Save the run config + git head as ``config.json`` (reference
    ``src/config.py:70-84``)."""
    pathlib.Path(dst_directory).mkdir(parents=True, exist_ok=True)
    config = dict(config)
    config["git_head"] = get_git_commit_head()
    with open(os.path.join(dst_directory, "config.json"), "w") as file:
        json.dump(config, file, indent=4, default=str)


def get_git_commit_head() -> str:
    try:
        head = subprocess.check_output(
            "git rev-parse HEAD", stderr=subprocess.DEVNULL, shell=True)
        return head.decode("utf-8").strip()
    except (subprocess.SubprocessError, UnicodeDecodeError):
        logger.warning("Git commit is not saved.")
        return ""


def model_cfg(cfg: dict) -> dict:
    return cfg["models"]["VANeRF"]


def disc_cfg(cfg: dict) -> dict:
    return cfg["models"]["Discriminator"]


def default_cfg() -> dict:
    """``configs/vanerf.json`` from the repository root."""
    here = pathlib.Path(__file__).resolve().parent.parent
    return load_cfg(str(here / "configs" / "vanerf.json"))

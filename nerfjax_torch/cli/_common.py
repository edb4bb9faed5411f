"""Shared CLI helpers (counterpart of ``nerfjax/cli/_common.py``, without its
JAX compilation cache). Configs load through ``nerfjax_torch.config``, which
imports PyYAML only when it reads a YAML file."""

from __future__ import annotations

import argparse


def cfg_parser(description: str, device: bool = True) -> argparse.ArgumentParser:
    """--cfg_path, and --device for the tools that run on the card."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cfg_path", type=str, required=True)
    if device:
        p.add_argument("--device", type=str, default="cuda",
                       help="torch device to run on (default: cuda; 'cpu' runs the "
                            "kernels' plain PyTorch versions)")
    return p


def load_cfg(args):
    from nerfjax_torch.config import load_config, with_defaults

    return with_defaults(load_config(args.cfg_path))

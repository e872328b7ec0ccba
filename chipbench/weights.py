"""Weights from the seed, on the device, one call a leaf.

The structure is the one the port's API declares (`api.abstract_params`:
every leaf's shape and dtype); the values follow the configuration
file's ``bench.init``: ``{"leaf name": rule}`` with a ``"default"``, each
rule one of ``{"const": v}``, ``{"std": s}`` (normal, standard deviation
``s``) or ``{"fan_in": g}`` (normal, standard deviation ``g /
sqrt(shape[-2])``, the leaf's input width). The program and the
reference are handed these same tensors.
"""
from __future__ import annotations

import math

import torch


def make(meta: dict, init: dict, generator: torch.Generator, device):
    """A tree like ``meta`` (tensors on ``meta``), filled on ``device``."""
    return {k: (make(v, init, generator, device) if isinstance(v, dict)
                else _leaf(k, v, init, generator, device))
            for k, v in meta.items()}


def _leaf(name, m, init, generator, device):
    r = init.get(name, init["default"])
    t = torch.empty(m.shape, dtype=m.dtype, device=device)
    if "const" in r:
        return t.fill_(float(r["const"]))
    std = (float(r["std"]) if "std" in r
           else float(r["fan_in"]) / math.sqrt(m.shape[-2]))
    return t.normal_(0.0, std, generator=generator)

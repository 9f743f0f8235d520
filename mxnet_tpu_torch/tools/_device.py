"""Where a tool runs and where it was measured: shared by the port's
repo tools (``gen_op_docs``, ``gen_api_docs``, ``c_api_coverage``,
``bandwidth``, ``bench_pipeline``, ``baseline_matrix``).

A tool runs on ``cuda:0`` unless the caller passes ``--device cpu``;
without a card it raises instead of falling back to the host. Each
record it prints carries the device and, on a card, the card's name and
power limit as ``nvidia-smi`` reports them."""
from __future__ import annotations

import subprocess

import torch

from ..base import MXNetError

__all__ = ["add_argument", "resolve", "card", "fields"]


def add_argument(ap):
    ap.add_argument("--device", default="cuda:0",
                    help="'cpu' to run on the host (default: the card, cuda:0)")


def resolve(name):
    """``--device``'s value as a ``torch.device``; a CUDA device without a
    card raises."""
    dev = torch.device(name or "cuda:0")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError("no CUDA device: the tool runs on the card (%s) unless "
                         "--device cpu is given" % dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def card(dev):
    """``{"name", "power_limit"}`` of ``dev``'s card from ``nvidia-smi``,
    or ``{}`` on the host."""
    if dev.type != "cuda":
        return {}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(dev.index or 0)],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    name, _, limit = out.rpartition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


_CARD = {}


def fields(dev):
    """The fields every record of a tool carries: ``device`` and, on a
    card, its ``name`` and ``power_limit`` (read once per process)."""
    key = str(dev)
    if key not in _CARD:
        _CARD[key] = dict({"device": key}, **card(dev))
    return dict(_CARD[key])

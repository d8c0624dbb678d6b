"""The one traffic generator: how the rows of a cell's table reach the
program, from the parameters in ``traffic/<name>.json``.

Parameters:

* ``loop``: ``"closed"`` -- a session sends one query, waits for its
  results, then sends the next;
* ``sessions``: closed-loop sessions (1: one process, one stream);
* ``row_order``: the order of the table's rows as the query scans them:
  ``"as_generated"`` (the order the generator writes, as dbgen writes
  lineitem: by orderkey) or ``"permuted"`` (a permutation drawn from the
  seed, as a parallel scan or an unclustered load delivers rows).
"""
from __future__ import annotations

import torch

ROW_ORDERS = ("as_generated", "permuted")


def validate(traffic: dict) -> None:
    if traffic.get("loop") != "closed":
        raise ValueError(f"only closed-loop traffic is generated, got "
                         f"{traffic.get('loop')!r}")
    if int(traffic.get("sessions", 0)) != 1:
        raise ValueError("one closed-loop session per process: concurrent "
                         "sessions would share the one card")
    if traffic.get("row_order") not in ROW_ORDERS:
        raise ValueError(f"row_order must be one of {ROW_ORDERS}")


def arrange(values: torch.Tensor, keys: torch.Tensor, traffic: dict,
            seed: int):
    """The rows in the mix's order (``values`` (n, C), ``keys`` (n,))."""
    validate(traffic)
    order = traffic["row_order"]
    if order == "as_generated":
        return values, keys
    gen = torch.Generator(device=keys.device)
    gen.manual_seed(seed)
    perm = torch.randperm(keys.shape[0], generator=gen, device=keys.device)
    return values[perm].contiguous(), keys[perm].contiguous()

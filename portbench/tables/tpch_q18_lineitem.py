"""TPC-H Q18's inner ``select l_orderkey, sum(l_quantity) from lineitem
group by l_orderkey``: LINEITEM drawn on the device from a seed by dbgen's
rules (TPC-H spec 4.2.3), in dbgen's order (by orderkey).

A copy of ``chip_smoke.py::q18_table``, kept here so that the yardstick does
not move with the program's scripts: an order has 1..7 lineitems,
``l_quantity`` is 1..50 (float32, one column), and the group id is the
order's dense index 0..orders-1 (dbgen's orderkeys are sparse: 8 of every
32 keys are used).

``draw`` returns ``(values (n, 1) float32, keys (n,) int32, groups)``.
"""
from __future__ import annotations

import torch



def draw(device, config: dict, seed: int) -> tuple:
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    orders = int(config["orders"])
    lo, hi = config["lineitems_per_order"]
    per_order = torch.randint(lo, hi + 1, (orders,), generator=gen,
                              device=dev)
    keys = torch.repeat_interleave(
        torch.arange(orders, dtype=torch.int32, device=dev), per_order)
    del per_order
    lo, hi = config["quantity"]
    qty = torch.randint(lo, hi + 1, (keys.shape[0],), generator=gen,
                        device=dev)
    return qty.to(torch.float32)[:, None].contiguous(), keys, orders

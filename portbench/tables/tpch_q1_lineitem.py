"""TPC-H Q1's input: the LINEITEM rows that pass Q1's predicate, drawn on
the device from a seed by dbgen's rules (TPC-H spec 4.2.3).

A copy of ``chip_smoke.py::q1_table``, kept here so that the yardstick does
not move with the program's scripts, and extended to whole orders, dates,
``l_tax``, the shipdate predicate and the returnflag / linestatus rules:

* an order has 1..7 lineitems and one ``o_orderdate`` uniform over
  [STARTDATE, ENDDATE - 151 days];
* ``l_shipdate`` = orderdate + 1..121 days, ``l_receiptdate`` = shipdate +
  1..30 days;
* ``l_returnflag`` is 'R' or 'A' (even odds) when receiptdate <=
  CURRENTDATE, else 'N'; ``l_linestatus`` is 'O' when shipdate >
  CURRENTDATE, else 'F';
* ``l_quantity`` 1..50, ``l_discount`` 0.00..0.10, ``l_tax`` 0.00..0.08,
  ``l_extendedprice`` = quantity x p_retailprice of a part drawn from the
  scale factor's parts, p_retailprice = (90000 + (partkey / 10) mod 20001 +
  100 (partkey mod 1000)) / 100.

Rows stay in dbgen's order (by orderkey).  Q1's predicate ``l_shipdate <=
date '1998-12-01' - interval '90' day`` is applied here; the query gets
the passing rows.  Columns, as Q1 reads them (float32, computed exactly in
integer cents and rounded once): quantity, extendedprice, discount,
disc_price = price x (1 - discount), charge = disc_price x (1 + tax).  The
group id is (returnflag, linestatus) in Q1's output order: A-F 0, N-F 1,
N-O 2, R-F 3.  Days count from 1992-01-01 (day 0).

``draw`` returns ``(values (n, 5) float32, keys (n,) int32, groups)``.
"""
from __future__ import annotations

import torch



def _uniform(lo: int, hi: int, n: int, gen, dev) -> torch.Tensor:
    """n integers uniform on [lo, hi] (both ends included), int64."""
    return torch.randint(lo, hi + 1, (n,), generator=gen, device=dev)


def draw(device, config: dict, seed: int) -> tuple:
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    orders = int(config["orders"])
    per_order = _uniform(*config["lineitems_per_order"], orders, gen, dev)
    odate = _uniform(*config["orderdate_days"], orders, gen, dev)
    ship = torch.repeat_interleave(odate, per_order)
    del odate, per_order
    n = ship.shape[0]
    ship += _uniform(*config["shipdate_after_order_days"], n, gen, dev)
    receipt = ship + _uniform(*config["receiptdate_after_ship_days"], n,
                              gen, dev)
    current = int(config["currentdate_day"])
    returned = receipt <= current
    del receipt
    coin = _uniform(0, 1, n, gen, dev).bool()
    # A-F 0, N-F 1, N-O 2, R-F 3 (a returned line shipped before CURRENTDATE)
    keys = torch.where(returned, torch.where(coin, 3, 0),
                       torch.where(ship > current, 2, 1)).to(torch.int32)
    del returned, coin
    qty = _uniform(*config["quantity"], n, gen, dev)
    part = _uniform(1, int(config["parts"]), n, gen, dev)
    retail = 90_000 + (part // 10) % 20_001 + 100 * (part % 1000)  # cents
    del part
    disc = _uniform(*config["discount_percent"], n, gen, dev)
    tax = _uniform(*config["tax_percent"], n, gen, dev)
    price = qty * retail                                          # cents
    del retail
    f64 = torch.float64
    cols = [qty.to(f64), price.to(f64) / 100, disc.to(f64) / 100,
            (price * (100 - disc)).to(f64) / 10_000,
            (price * (100 - disc) * (100 + tax)).to(f64) / 1_000_000]
    del qty, price, disc, tax
    keep = ship <= int(config["last_shipdate_day"])
    values = torch.stack([c.to(torch.float32) for c in cols], dim=1)
    del cols, ship
    return (values[keep].contiguous(), keys[keep].contiguous(),
            int(config["groups"]))

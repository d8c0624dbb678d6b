"""The copied generators keep dbgen's domains (TPC-H 4.2.3) at a tiny
scale, and the same seed draws the same table."""
import pytest

torch = pytest.importorskip("torch")

from portbench.tests._cpu import ROOT, TINY  # noqa: E402
from portbench import catalog, traffic  # noqa: E402


def _draw(name, seed=123, **over):
    b = catalog.Benchmark(ROOT)
    cfg = dict(b.config(name), **TINY, **over)
    return b.generator(cfg).draw("cpu", cfg, seed)


def _is_multiple(x, step, atol=1e-6):
    return torch.allclose(torch.round(x / step) * step, x, rtol=0, atol=atol)


def test_q1_columns_keep_dbgen_domains():
    values, keys, groups = _draw("tpch_sf10_q1")
    qty, price, disc, dprice, charge = values.double().unbind(1)
    assert groups == 4 and keys.dtype == torch.int32
    assert sorted(keys.unique().tolist()) == [0, 1, 2, 3]
    assert torch.equal(qty, qty.round()) and qty.min() >= 1 \
        and qty.max() <= 50
    assert disc.min() >= 0 and disc.max() <= 0.10 + 1e-7
    assert _is_multiple(disc * 100, 1.0)
    retail = price / qty                                   # p_retailprice
    assert retail.min() >= 900 - 1e-2 and retail.max() <= 2099 + 1e-2
    assert torch.allclose(dprice, price * (1 - disc), rtol=1e-6)
    tax = charge / dprice - 1
    assert tax.min() >= -1e-6 and tax.max() <= 0.08 + 1e-6
    assert _is_multiple(tax * 100, 1.0, atol=1e-3)   # float32 columns


def test_q1_groups_follow_the_returnflag_and_linestatus_rules():
    """A-F and R-F take about a quarter each, N-O about half, N-F under 1%
    (shipped before CURRENTDATE, received after); the predicate drops
    about 1.4% of the lines."""
    cfg_rows = _draw("tpch_sf10_q1", last_shipdate_day=10 ** 6)[1].numel()
    values, keys, _ = _draw("tpch_sf10_q1")
    share = torch.bincount(keys.long(), minlength=4).double() / keys.numel()
    assert abs(share[0] - share[3]) < 0.03                  # even odds A/R
    assert 0.2 < share[0] < 0.3 and 0.45 < share[2] < 0.55
    assert 0 < share[1] < 0.02
    assert 0.97 < keys.numel() / cfg_rows < 0.995


def test_q18_orders_have_1_to_7_lineitems_in_orderkey_order():
    values, keys, groups = _draw("tpch_sf10_q18")
    assert groups == TINY["orders"] and values.shape == (keys.numel(), 1)
    per = torch.bincount(keys.long(), minlength=groups)
    assert per.min() >= 1 and per.max() <= 7
    assert torch.equal(keys, torch.sort(keys).values)       # dbgen's order
    q = values[:, 0]
    assert torch.equal(q, q.round()) and q.min() >= 1 and q.max() <= 50


@pytest.mark.parametrize("name", ["tpch_sf10_q1", "tpch_sf10_q18"])
def test_the_seed_draws_the_table(name):
    a, b, c = _draw(name, seed=7), _draw(name, seed=7), _draw(name, seed=8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].shape != c[0].shape or not torch.equal(a[0], c[0])


def test_traffic_orders_keep_the_rows():
    values, keys, _ = _draw("tpch_sf10_q18")
    for order in traffic.ROW_ORDERS:
        mix = {"loop": "closed", "sessions": 1, "row_order": order}
        v, k = traffic.arrange(values, keys, mix, seed=5)
        assert torch.equal(torch.sort(k).values, torch.sort(keys).values)
        assert torch.equal(v[:, 0].sum(), values[:, 0].sum())
    v, k = traffic.arrange(values, keys, {"loop": "closed", "sessions": 1,
                                          "row_order": "permuted"}, seed=5)
    assert not torch.equal(k, keys)
    with pytest.raises(ValueError):
        traffic.arrange(values, keys, {"loop": "open", "sessions": 1,
                                       "row_order": "permuted"}, seed=5)

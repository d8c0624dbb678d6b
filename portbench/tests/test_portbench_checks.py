"""What decides ``correct``: a run of the program passes; the control (the
plain reference in bfloat16, the precision below the configurations'
float32) and each fault the cells can have fail.  Each run skips the
look for a card and drives the rest of a run on the CPU at a tiny size,
with the timed path broken underneath."""
import math

import pytest

torch = pytest.importorskip("torch")

from portbench.tests._cpu import CELLS, ROOT, cpu_run  # noqa: E402
from portbench import catalog, checks, harness  # noqa: E402
from portbench.readings import control_entry  # noqa: E402


def _program(device="cpu"):
    return harness.program_entry(torch.device(device))


def half_the_rows(values, keys, groups, aggs):
    """Half of the batch left out: the aggregate (and its mean) over the
    rest."""
    n = keys.shape[0] // 2
    return _program()(values[:n], keys[:n], groups, aggs)


def unchanged_state(values, keys, groups, aggs):
    """The state returned as it came in: the empty state, finalized (sums
    and counts 0, means NaN)."""
    out = _program()(values, keys, groups, aggs)
    return {k: torch.full_like(v, math.nan if k.startswith("mean") else 0.0)
            for k, v in out.items()}


def altered_answer(values, keys, groups, aggs):
    """One answer altered where it is produced: the first group's first
    result scaled by 1 + 2^-10."""
    out = _program()(values, keys, groups, aggs)
    name = next(iter(out))
    out[name] = out[name].clone()
    out[name][0] *= 1 + 2.0 ** -10
    return out


def order_dependent(values, keys, groups, aggs):
    """A float32 aggregate whose bits follow the row order (index_add_ in
    row order): the guarantee broken, the sums within rounding."""
    cols = sorted({a[1] for a in aggs if a[0] != "count"})
    x = torch.cat([values[:, cols], torch.ones_like(values[:, :1])], 1)
    sums = torch.zeros((groups, x.shape[1])).index_add_(0, keys.long(), x)
    out = {}
    for a in aggs:
        if a[0] == "count":
            out["count(*)"] = sums[:, -1]
        elif a[0] == "sum":
            out[f"sum({a[1]})"] = sums[:, cols.index(a[1])]
        else:
            out[f"mean({a[1]})"] = sums[:, cols.index(a[1])] / sums[:, -1]
    return out


class _Flaky:
    """The set-up's two answers and the window's first right, every later
    answer altered, so that every sampled answer differs from the first
    whatever the timing."""

    def __init__(self):
        self.calls = 0

    def __call__(self, values, keys, groups, aggs):
        self.calls += 1
        if self.calls <= 3:
            return _program()(values, keys, groups, aggs)
        return altered_answer(values, keys, groups, aggs)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(cell):
    res = cpu_run(cell)
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_is_not_correct(cell):
    """At 20,000 orders some orders' quantities sum past 256, where
    bfloat16 holds only even integers (at SF10 every seed reads 65,536
    ulp)."""
    b = catalog.Benchmark(ROOT)
    c = b.cell(cell)
    res = cpu_run(cell, entry=control_entry(b, c.config, torch.bfloat16),
                  scale={"orders": 20_000})
    assert res["correct"] is False
    n = res["checks"]["max_err_ulp"]
    assert n["value"] > n["limit"]


@pytest.mark.parametrize("fault,number,cells", [
    (half_the_rows, "max_err_ulp", ("q1_sf10", "q18_sf10_shuffled")),
    (unchanged_state, "max_err_ulp", ("q1_sf10", "q18_sf10_shuffled")),
    (altered_answer, "max_err_ulp", ("q1_sf10", "q18_sf10_shuffled")),
    # Q18's sums are integers under 2^24: every order gives the same bits
    (order_dependent, "perm_diff", ("q1_sf10",))])
def test_each_fault_is_not_correct(fault, number, cells):
    for cell in cells:
        res = cpu_run(cell, entry=fault)
        assert res["correct"] is False
        n = res["checks"][number]
        assert n["value"] > n["limit"], (cell, res["checks"])


def test_an_answer_that_changes_within_the_window_is_not_correct():
    res = cpu_run("q18_sf10_ordered", seconds=1.0, entry=_Flaky())
    assert res["correct"] is False
    assert res["checks"]["window_diff"]["value"] > 0


def test_ulp_gaps_and_bit_differences():
    ref = {"s": torch.tensor([1.0, 2.0 ** 30, 0.0], dtype=torch.float64)}
    one_ulp = torch.tensor([1.0 + 2 ** -23, 2.0 ** 30, 0.0])
    assert checks.max_err_ulp({"s": one_ulp}, ref) == 1.0
    assert checks.max_err_ulp({"t": one_ulp}, ref) == math.inf
    nan = torch.tensor([float("nan"), 2.0 ** 30, 0.0])
    assert checks.max_err_ulp({"s": nan}, ref) == math.inf
    a = {"s": torch.tensor([0.0, 1.0])}
    assert checks.bit_diff(a, {"s": torch.tensor([-0.0, 1.0])}) == 1
    assert checks.bit_diff(a, {"s": torch.tensor([0.0, 1.0])}) == 0
    assert checks.passed({"x": {"value": 0, "limit": None}}) is False


def test_a_traced_run_reads_its_stretch():
    res = cpu_run("q18_sf10_ordered", seconds=1.0, trace=True)
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["correct"] is True

"""The rank path on the card, over NCCL: a tiny Q1 whose configuration
names ``sharded_groupby_agg`` runs as one rank, and as four where the
machine has four cards.  Marked ``cuda``: it skips without a card.

    python -m pytest -q -m cuda portbench/tests/test_portbench_ranks_card.py
"""
import pytest

torch = pytest.importorskip("torch")

from portbench.tests import _ranks  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 4])
def test_the_rank_path_over_nccl_is_correct(tmp_path, world):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA cards")
    root = _ranks.bench_copy(tmp_path, {"tiny": ("sharded_groupby_agg",
                                                 world)})
    for trace in (False, True):
        res = _ranks.result(_ranks.run(root, "tiny", seconds=2.0,
                                       trace=trace, device="cuda",
                                       timeout_s=120.0))
        assert res["correct"] is True, res["checks"]
        assert res["device"]["platform"] == "gpu"
        assert res["device"]["count"] == world
        assert res["device"]["memory_peak_bytes"] > 0
        if trace:
            assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]

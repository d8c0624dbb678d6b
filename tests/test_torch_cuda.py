"""On the card: the hand-written CUDA kernels against their plain PyTorch
versions, ``groupby_agg`` on the card against the CPU, bit for bit, the
measured planner's calibration on the card, and the paper's baselines on
the card against the CPU.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
module imports neither JAX nor the JAX package, so it also runs where JAX is
not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import accumulator as acc  # noqa: E402
from repro_torch.core.types import ReproSpec  # noqa: E402
from repro_torch.kernels.rsum import ops as rsum_ops  # noqa: E402
from repro_torch.kernels.segment_rsum import ops as seg_ops  # noqa: E402
from repro_torch.ops import groupby_agg  # noqa: E402

SPECS = [ReproSpec(L=1), ReproSpec(L=2), ReproSpec(L=3), ReproSpec(L=2, W=12)]
AGGS = [("sum", 0), ("count",), ("mean", 0), ("var", 1), ("std", 1),
        ("sum_prod", 0, 1), ("min", 0), ("max", 1)]


def _values(kind, n, ncols, seed):
    rng = np.random.default_rng(seed)
    if kind == "wide":
        x = rng.standard_normal((n, ncols)) * np.exp(
            rng.standard_normal((n, ncols)) * 3)
    elif kind == "denormal":
        tiny = np.float32(1.4e-45) * rng.integers(1, 200, (n, ncols))
        x = np.where(rng.random((n, ncols)) < 0.4, tiny,
                     rng.standard_normal((n, ncols)) * 0.25)
        x[0] = 1.0
    elif kind == "cancel":
        half = rng.standard_normal((n // 2, ncols)) * 1e3
        noise = rng.standard_normal((n - 2 * (n // 2), ncols)) * 1e-3
        x = np.concatenate([half, -half, noise])
        rng.shuffle(x)
    else:
        assert kind == "carry"
        x = 1000.0 + rng.random((n, ncols)) * 64
    return x.astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_cuda_kernels_match_plain(cuda, spec):
    for (n, g, ncols), kind in [((1, 1, 1), "wide"), ((4096, 100, 3), "wide"),
                                ((50_001, 700, 6), "cancel"),
                                ((20_000, 4, 2), "denormal"),
                                ((200_000, 70_000, 1), "carry")]:
        x = torch.from_numpy(_values(kind, n, ncols, seed=n)).to(cuda)
        ids = torch.from_numpy(np.random.default_rng(g).integers(
            0, g, n).astype(np.int32)).to(cuda)
        e1 = acc.required_e1(x, spec, axis=0)
        A, iu = rsum_ops.ladder(e1, spec, (0, spec.L))
        before = seg_ops.LAUNCHES
        for got, want in (
                (seg_ops.segment_levels_kernel(x, ids, g, A, iu, spec),
                 seg_ops.segment_levels_plain(x, ids, g, A, iu, spec)),
                (seg_ops.segment_levels_kernel(x, ids, g, A, iu, spec, 8),
                 seg_ops.segment_levels_plain(x, ids, g, A, iu, spec)),
                (rsum_ops.rsum_levels_kernel(x, A, iu, spec),
                 rsum_ops.rsum_levels_plain(x, A, iu, spec))):
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b), (n, g, ncols, kind)
        assert seg_ops.LAUNCHES == before + 4      # two kernels a call


@pytest.mark.cuda
def test_groupby_on_the_card_equals_the_cpu(cuda):
    x = _values("wide", 30_000, 2, seed=2)
    for g in (1, 4, 50, 5000):
        keys = np.random.default_rng(g).integers(0, g, 30_000) \
            .astype(np.int32)
        launches = (seg_ops.LAUNCHES, rsum_ops.LAUNCHES)
        on_card = groupby_agg(x, keys, g, AGGS)       # default device: cuda
        on_cpu = groupby_agg(x, keys, g, AGGS, device="cpu")
        assert (seg_ops.LAUNCHES, rsum_ops.LAUNCHES) != launches
        for name in on_cpu:
            assert on_card[name].device.type == "cuda"
            assert on_card[name].cpu().numpy().tobytes() == \
                on_cpu[name].numpy().tobytes(), (g, name)


def _same_as_plain(x, ids, g, spec, tile=None):
    """Both kernels against their plain versions, bit for bit; returns the
    segment launch's path."""
    e1 = acc.required_e1(x, spec, axis=0)
    A, iu = rsum_ops.ladder(e1, spec, (0, spec.L))
    got = seg_ops.segment_levels_kernel(x, ids, g, A, iu, spec, tile)
    want = seg_ops.segment_levels_plain(x, ids, g, A, iu, spec)
    got_f = rsum_ops.rsum_levels_kernel(x, A, iu, spec)
    want_f = rsum_ops.rsum_levels_plain(x, A, iu, spec)
    torch.cuda.synchronize()
    for a, b in zip(got + got_f, want + want_f):
        assert torch.equal(a, b), (tuple(x.shape), g, spec)
    return seg_ops.launch_shape(x.shape[0], g, x.shape[1], spec.L, 132,
                                tile).path


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_cuda_kernels_ragged_shapes(cuda, spec):
    """Row counts around the 4-row and 16-byte vector edges, every column
    count of the rsum column mapping and the private path's templates."""
    for n in (1, 3, 5, 4097):
        for ncols in (1, 3, 4, 5, 6, 7, 8):
            x = torch.from_numpy(_values("wide", n, ncols,
                                         seed=n * 10 + ncols)).to(cuda)
            ids = torch.from_numpy(np.random.default_rng(ncols).integers(
                0, 3, n).astype(np.int32)).to(cuda)
            _same_as_plain(x, ids, 3, spec)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_cuda_kernels_at_path_limits(cuda, spec):
    """G on each side of the private-table limit and of the tiled path's
    one-tile limit, with padding ids (-1) among the rows; every path is
    reached."""
    seen = set()
    for ncols in (1, 6):
        private_max, one_tile = seg_ops.group_limits(ncols, spec.L)
        for g in (private_max, private_max + 1, one_tile, one_tile + 1):
            if g < 1:
                continue
            n = 20_000
            x = torch.from_numpy(_values("cancel", n, ncols, seed=g)) \
                .to(cuda)
            rng = np.random.default_rng(g)
            ids = rng.integers(0, g, n).astype(np.int32)
            ids[rng.random(n) < 0.1] = -1
            seen.add(_same_as_plain(
                x, torch.from_numpy(ids).to(cuda), g, spec))
    assert seen == set(seg_ops.PATHS)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_cuda_kernels_unaligned_views(cuda, spec):
    """Contiguous views whose data_ptr is not 16-byte aligned take the
    scalar head, tail and row loads; sorted ids put a whole warp on one
    group."""
    for n, g, ncols in [(4097, 3, 6), (10_001, 700, 5), (3, 2, 4),
                        (50_000, 20_000, 1)]:
        flat = torch.from_numpy(_values("wide", n * ncols + 1, 1,
                                        seed=n)[:, 0]).to(cuda)
        x = flat[1:].view(n, ncols)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
        raw = torch.from_numpy(np.sort(np.random.default_rng(n).integers(
            0, g, n + 1)).astype(np.int32)).to(cuda)
        ids = raw[1:]
        assert ids.data_ptr() % 16 != 0
        _same_as_plain(x, ids, g, spec)


@pytest.mark.cuda
def test_calibration_on_the_card_steers_a_bit_identical_plan(cuda, tmp_path):
    from repro_torch.ops import calibrate as cal_mod
    from repro_torch.ops.plan import plan_groupby

    spec = ReproSpec()
    cal = cal_mod.calibrate(spec, grid=[(1 << 16, 1, 2), (1 << 16, 16, 2)],
                            backend="cuda", path=str(tmp_path / "c.json"))
    assert cal_mod.load(str(tmp_path / "c.json")).points == cal.points
    assert {p["method"] for p in cal.points} == {
        "scatter", "sort", "onehot", "pallas", "rsum"}
    assert all(p["ns_per_row"] > 0 for p in cal.points)
    x = _values("wide", 50_000, 2, seed=3)
    keys = np.random.default_rng(3).integers(0, 16, 50_000).astype(np.int32)
    plan = plan_groupby(50_000, 16, spec, ncols=2, calibration=cal)
    assert plan.source == "measured"
    on_card = groupby_agg(x, keys, 16, AGGS, method=plan.method)
    on_cpu = groupby_agg(x, keys, 16, AGGS, device="cpu")
    for name in on_cpu:
        assert on_card[name].cpu().numpy().tobytes() == \
            on_cpu[name].numpy().tobytes(), name


@pytest.mark.cuda
def test_baselines_on_the_card_equal_the_cpu(cuda):
    from repro_torch.core import buffers, rsum
    from repro_torch.numerics import DecimalSpec, decimal_segment_sum

    spec = ReproSpec()
    x = _values("wide", 2048, 1, seed=4)[:, 0] / 1e3
    ids = np.random.default_rng(4).integers(0, 8, 2048).astype(np.int32)
    calls = (
        lambda v, k: rsum.rsum_scalar(v[:256], spec),
        lambda v, k: rsum.rsum_simd(v, spec, V=8),
        lambda v, k: rsum.rsum_simd_chunked(v, spec, c=512, V=8),
        lambda v, k: buffers.flush_all(buffers.append(
            buffers.init(8, 16, spec, device=v.device), k, v, spec), spec),
        lambda v, k: decimal_segment_sum(v, k, 8, DecimalSpec(9, 4)),
    )
    for fn in calls:
        got = fn(torch.from_numpy(x).to(cuda), torch.from_numpy(ids).to(cuda))
        want = fn(torch.from_numpy(x), torch.from_numpy(ids))
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and a.dtype == b.dtype
            assert a.cpu().numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.cuda
def test_stream_store_on_the_card_equals_the_cpu(cuda, tmp_path):
    """A card store (card tensors and host batches, a WAL, a snapshot, a
    recovery, 2 hash shards, a window ring) holds the CPU store's bits, and
    its micro-batches launch the kernels."""
    from repro_torch import stream
    from repro_torch.obs import fingerprint as fp

    spec = ReproSpec()
    x = _values("wide", 40_000, 2, seed=5)
    keys = np.random.default_rng(5).integers(0, 13, 40_000).astype(np.int32)
    cuts = [slice(i, i + 5000) for i in range(0, 40_000, 5000)]
    cpu = stream.StreamStore(13, AGGS, spec, device="cpu")
    for c in cuts:
        cpu.ingest(x[c], keys[c])
    before = seg_ops.LAUNCHES
    card = stream.StreamStore(13, AGGS, spec, wal=tmp_path / "a.wal")
    assert card.device.type == "cuda"
    xc, kc = torch.from_numpy(x).to(cuda), torch.from_numpy(keys).to(cuda)
    for i, c in enumerate(cuts):
        card.ingest(xc[c] if i % 2 else x[c], kc[c] if i % 2 else keys[c],
                    client="t", seq=i)
        if i == 3:
            card.snapshot(str(tmp_path / "snaps"))
    assert seg_ops.LAUNCHES - before >= 2 * len(cuts)
    assert card.state().table.k.device.type == "cuda"
    assert card.fingerprints() == cpu.fingerprints()
    card.wal.close()
    again = stream.StreamStore.recover(tmp_path / "a.wal",
                                       str(tmp_path / "snaps"))
    assert again.fingerprints() == cpu.fingerprints()
    assert again.ingest(x[cuts[0]], keys[cuts[0]], client="t",
                        seq=0)["duplicate"]
    again.wal.close()
    sharded = stream.ShardedStreamStore(13, AGGS, spec, num_shards=2,
                                        policy="key_hash")
    for c in cuts:
        sharded.ingest(xc[c], kc[c])
    assert sharded.fingerprints() == cpu.fingerprints()
    t = np.random.default_rng(6).uniform(0.0, 40.0, 40_000)
    wins = [stream.WindowedStore(13, AGGS, spec, width=10.0, retention=2,
                                 device=d) for d in ("cpu", cuda)]
    for c in cuts:
        wins[0].ingest(x[c], keys[c], t[c])
        wins[1].ingest(xc[c], kc[c], torch.from_numpy(t[c]).to(cuda))
    assert wins[0].fingerprints() == wins[1].fingerprints()
    assert wins[0].late_dropped == wins[1].late_dropped
    flat = stream.StreamStore(1, [("sum", 0), ("count",)], spec)
    before = rsum_ops.LAUNCHES
    for c in cuts:
        flat.ingest(xc[c], torch.zeros_like(kc[c]))
    assert rsum_ops.LAUNCHES - before >= len(cuts)
    res = groupby_agg(x, np.zeros_like(keys), 1, [("sum", 0), ("count",)],
                      device="cpu")
    assert flat.fingerprints()["stream/results"] == \
        fp.fingerprint_results(res)


def _smollm(n_layers=None):
    import dataclasses

    from repro_torch import configs
    cfg = configs.get_config("smollm-135m")
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


@pytest.mark.cuda
def test_microbatch_gradient_twice_on_the_card_is_byte_identical(cuda):
    """One quantum's forward and backward (smollm-135m, full width and
    depth, bfloat16) twice: the same bytes in every gradient leaf."""
    from repro_torch import tree as tree_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train_step import TrainConfig, make_train_step
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig

    cfg = _smollm()
    step = make_train_step(cfg, TrainConfig(grad_mode="repro"), make_mesh(),
                           ShapeConfig("t", 256, 1, "train"), device=cuda)
    params = lm.init_params(0, cfg, cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 257))
                            .astype(np.int32)).to(cuda)
    mb = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    g1, m1 = step.grad_fn(params, mb)
    g2, m2 = step.grad_fn(params, mb)
    assert torch.isfinite(m1["loss"])
    assert m1["loss"].item() == m2["loss"].item()
    for (path, a), b in zip(tree_mod.paths(g1), tree_mod.leaves(g2)):
        assert a.dtype == torch.bfloat16 and a.device.type == "cuda"
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), path


@pytest.mark.cuda
def test_full_width_global_norm_runs_rsum_with_the_cpu_bits(cuda):
    from repro_torch import tree as tree_mod
    from repro_torch.models import lm
    from repro_torch.optim import grad

    spec = ReproSpec()
    grads = tree_mod.tree_map(lambda p: (p.float() * 3.0 - 1e-3).to(
        torch.bfloat16), lm.init_params(1, _smollm(), "cpu"))
    before = rsum_ops.LAUNCHES
    on_card = grad.repro_global_norm(
        tree_mod.tree_map(lambda g: g.to(cuda), grads), spec)
    assert rsum_ops.LAUNCHES - before == len(tree_mod.leaves(grads))
    on_cpu = grad.repro_global_norm(grads, spec)
    assert on_card.cpu().numpy().tobytes() == on_cpu.numpy().tobytes()


@pytest.mark.cuda
def test_repro_step_equals_repro_zero2_step_on_the_card(cuda):
    from repro_torch import tree as tree_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import build_batch
    from repro_torch.launch.train_step import TrainConfig, make_train_step
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig

    cfg = _smollm(n_layers=2)
    shape = ShapeConfig("t", 128, 4, "train")
    batch = build_batch(DataConfig(seed=3, global_batch=4, seq_len=128,
                                   vocab=cfg.vocab), cfg, 0, 4, 1,
                        device=cuda)
    out = {}
    for mode in ("repro", "repro_zero2"):
        step = make_train_step(cfg, TrainConfig(grad_mode=mode), make_mesh(),
                               shape, device=cuda)
        params = lm.init_params(2, cfg, cuda)
        out[mode] = step(params, step.init_opt(params), batch)
    (pa, oa, ma), (pb, ob, mb) = out["repro"], out["repro_zero2"]
    for k in ("loss", "xent", "grad_norm"):
        assert ma[k].item() == mb[k].item(), k
    for a, b in zip(tree_mod.leaves(pa), tree_mod.leaves(pb)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    for a, b in zip(tree_mod.leaves(oa.master), tree_mod.leaves(ob.master)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_moe_routing_under_bf16_ties_equals_the_cpu(cuda):
    """granite's router at full width in bfloat16: its logits tie often,
    and the card picks the CPU's experts (lower index first on ties); a
    whole MoE block on the card twice gives the same bytes."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import moe

    cfg = configs.get_config("granite-moe-3b-a800m")
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 512, cfg.d_model), generator=g).to(torch.bfloat16)
    router = (torch.randn((cfg.d_model, E), generator=g)
              * cfg.d_model ** -0.5).to(torch.bfloat16)
    probs = torch.softmax((x.to(cuda) @ router.to(cuda)).float(), dim=-1)
    v_card, i_card = moe.top_k(probs, K)
    v_cpu, i_cpu = moe.top_k(probs.cpu(), K)
    assert torch.equal(i_card.cpu(), i_cpu)
    assert torch.equal(v_card.cpu(), v_cpu)
    top = torch.sort(probs, dim=-1, descending=True).values[..., :K + 1]
    assert (top[..., 1:] == top[..., :-1]).any()         # ties happened
    small = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, d_ff_expert=64))
    p = moe.moe_init(torch.Generator().manual_seed(1), small, device=cuda)
    outs = [moe.moe_block(x.to(cuda), p, small, group=512)[0]
            for _ in range(2)]
    assert torch.equal(outs[0].view(torch.int16), outs[1].view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "hymba-1.5b",
                                  "xlstm-350m"])
def test_generate_twice_on_the_card_gives_the_same_bytes(cuda, arch):
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = configs.get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=2 * (1 + (arch == "xlstm-350m")))
    params = lm.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                             cuda)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32)).to(cuda)
    runs = [serve.generate_with_stats(params, cfg, prompts, max_seq=72,
                                      gen_steps=8, return_logits=True)
            for _ in range(2)]
    (t1, _, l1), (t2, _, l2) = runs
    assert t1.device.type == "cuda" and torch.equal(t1, t2)
    assert l1.dtype == torch.float32 and torch.equal(l1, l2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_recurrent_quantum_gradient_twice_is_byte_identical(cuda, arch):
    """One quantum of reduced hymba / xlstm over 72 steps (a checkpointed
    time chunk and a tail), twice: the same gradient bytes."""
    from repro_torch import configs
    from repro_torch import tree as tree_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train_step import TrainConfig, make_train_step
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig

    cfg = configs.get_config(arch).reduced()
    step = make_train_step(cfg, TrainConfig(grad_mode="repro"), make_mesh(),
                           ShapeConfig("t", 72, 1, "train"), device=cuda)
    params = lm.init_params(0, cfg, cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, 73)).astype(np.int32)).to(cuda)
    mb = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    g1, m1 = step.grad_fn(params, mb)
    g2, m2 = step.grad_fn(params, mb)
    assert torch.isfinite(m1["loss"]) and m1["loss"].item() == \
        m2["loss"].item()
    for (path, a), b in zip(tree_mod.paths(g1), tree_mod.leaves(g2)):
        assert torch.equal(a, b), path

"""The port's observability tools against the JAX package's: pytree
fingerprints, the run manifest and fingerprint files, the trace/metrics
report, and the fresh-process audit (run on the CPU, its digests held to
the JAX package's on the same workload)."""
import hashlib
import io
import json
import os
import subprocess
import sys
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.types import ReproSpec as RefSpec  # noqa: E402
from repro.obs import audit as ref_audit  # noqa: E402
from repro.obs import fingerprint as ref_fp  # noqa: E402
from repro.obs import report as ref_report  # noqa: E402
from repro.ops.groupby import groupby_agg as ref_groupby  # noqa: E402
from repro.stream import StreamStore as RefStore  # noqa: E402
from repro_torch.obs import audit, report  # noqa: E402
from repro_torch.obs import fingerprint as fp  # noqa: E402
from repro_torch.obs import metrics, trace  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
Pair = namedtuple("Pair", "lo hi")


@pytest.fixture(autouse=True, scope="module")
def _one_intraop_thread():
    """One torch thread per test process: the suite runs several worker
    processes on the host at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(as_tensor):
    conv = torch.from_numpy if as_tensor else (lambda a: a)
    return {
        "table/k": conv(np.arange(6, dtype=np.int32).reshape(2, 3)),
        "b": [conv(np.float32([1.5])), (conv(np.zeros(3)), None)],
        "q'x": Pair(conv(np.arange(2)), conv(np.ones((1, 2), np.float32))),
        "rows": conv(np.array(7, np.int32)),
        "nested": {"z": conv(np.int64([1, -1])), "a": [conv(np.ones(0))]},
    }


def test_fingerprint_pytree_equals_reference():
    want = ref_fp.fingerprint_pytree(_tree(False))
    assert fp.fingerprint_pytree(_tree(False)) == want
    assert fp.fingerprint_pytree(_tree(True)) == want
    # the digest is a function of the mapping, not of insertion order
    tree = _tree(True)
    assert fp.fingerprint_pytree(dict(reversed(list(tree.items())))) == want
    tree["rows"] = torch.tensor(8, dtype=torch.int32)
    assert fp.fingerprint_pytree(tree) != want


def test_run_manifest_records_the_ports_environment(tmp_path, monkeypatch):
    cache = tmp_path / "cal.json"
    cache.write_text("{}")
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION_CACHE", str(cache))
    man = fp.run_manifest(extra={"tag": "x"})
    assert man["torch_version"] == torch.__version__
    assert man["cuda_version"] == torch.version.cuda
    assert man["fingerprint_layout"] == fp.LAYOUT_VERSION
    assert man["device"] == (torch.cuda.get_device_name(0)
                             if torch.cuda.is_available() else "cpu")
    assert man["calibration_cache"]["path"] == str(cache)
    assert man["calibration_cache"]["sha256"] == \
        hashlib.sha256(b"{}").hexdigest()
    assert man["tag"] == "x" and "python" in man and "machine" in man
    assert not any(k.startswith("jax") for k in man)


def test_fingerprint_files_roundtrip_and_diff(tmp_path):
    a = {"x": "1" * 64, "y": "2" * 64}
    path = fp.write_fingerprints(str(tmp_path / "d" / "a.json"), a)
    got = fp.read_fingerprints(path)
    assert fp.MANIFEST_KEY in got and fp.diff_fingerprints(a, got) == []
    b = dict(a, y="3" * 64, z="4" * 64)
    b[fp.MANIFEST_KEY] = {"other": True}
    assert fp.diff_fingerprints(got, b) == ["y", "z"]
    # the JAX package reads the port's file and diffs it the same way
    assert ref_fp.diff_fingerprints(ref_fp.read_fingerprints(path), b) == \
        ["y", "z"]


def _records(tmp_path):
    """A trace and a metrics dump written by the port."""
    tpath, mpath = tmp_path / "t.jsonl", tmp_path / "m.json"
    trace.configure(str(tpath))
    try:
        with trace.span("stream.ingest", rows=3):
            trace.event("plan.partial", coalesce=2)
        with trace.span("stream.ingest", rows=4):
            pass
        trace.flush()
    finally:
        trace.disable()
    metrics.counter("test_report_rows_total", kind="a").inc(3)
    metrics.histogram("test_report_seconds").observe(0.25)
    metrics.dump(str(mpath))
    return tpath, mpath


def test_report_reads_the_ports_files_like_the_reference(tmp_path):
    tpath, mpath = _records(tmp_path)
    records = report.load_trace(str(tpath))
    assert [r["kind"] for r in records] == ["event", "span", "span"]
    payload = json.loads(mpath.read_text())
    for ours, theirs, arg in ((report.summarize_trace,
                               ref_report.summarize_trace, records),
                              (report.summarize_metrics,
                               ref_report.summarize_metrics, payload)):
        a, b = io.StringIO(), io.StringIO()
        ours(arg, out=a)
        theirs(arg, out=b)
        assert a.getvalue() == b.getvalue() and a.getvalue()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(tpath),
         str(mpath)], env=dict(os.environ, PYTHONPATH=str(SRC)),
        capture_output=True, text=True, timeout=120, check=True).stdout
    assert "stream.ingest" in out and "test_report_rows_total" in out
    assert "plan.partial" in out


def test_audit_dataset_and_digests_equal_reference():
    """The audit's workload holds float32 subnormals (1e-45), which XLA's
    CPU backend flushes to zero in arithmetic while the port keeps them;
    here they sit far below every group's extraction lattice and square to
    zero in both packages, so the digests agree exactly."""
    n = 4001
    v, k = audit._groupby_dataset(n, permute=False)
    rv, rk = ref_audit._groupby_dataset(n, permute=False)
    assert v.tobytes() == rv.tobytes() and k.tobytes() == rk.tobytes()
    assert (v == np.float32(1e-45)).any()
    spec = RefSpec(dtype=jnp.float32, L=audit.GROUPBY_L)
    res, tab = ref_groupby(v, k, audit.GROUPBY_G, aggs=audit.AGGS, spec=spec,
                           return_table=True)
    assert audit.groupby_fingerprints(v, k, "cpu") == {
        "groupby/table": ref_fp.fingerprint_table(tab, spec),
        "groupby/results": ref_fp.fingerprint_results(res)}
    # the stream family's one-batch variant, against the JAX package's store
    got = audit.stream_fingerprints(v, k, "cpu", batches=1)
    store = RefStore(audit.GROUPBY_G, aggs=audit.AGGS, spec=spec)
    store.ingest(v, k)
    assert got == store.fingerprints()


def test_audit_runs_fresh_processes_on_the_cpu(tmp_path):
    # one worker at a time: the test shares the host with the suite
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("REPRO_TRACE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.audit", "--out",
         str(tmp_path), "--quick", "--device", "cpu", "--serial",
         "--skip-train", "--timeout", "240"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    summary = json.loads((tmp_path / "audit_summary.json").read_text())
    assert (summary["status"], summary["groupby"], summary["stream"]) == \
        ("pass", "identical", "identical")
    base = fp.read_fingerprints(str(tmp_path / "fp_groupby_base.json"))
    assert base[fp.MANIFEST_KEY]["audit_device"] == "cpu"
    assert (tmp_path / "trace_stream_restart.jsonl").exists()
    # the port's digests are the JAX package's on the same workload
    v, k = audit._groupby_dataset(4001, permute=False)
    spec = RefSpec(dtype=jnp.float32, L=audit.GROUPBY_L)
    res, tab = ref_groupby(v, k, audit.GROUPBY_G, aggs=audit.AGGS, spec=spec,
                           return_table=True)
    assert base["groupby/table"] == ref_fp.fingerprint_table(tab, spec)
    assert base["groupby/results"] == ref_fp.fingerprint_results(res)


def test_audit_train_family_on_the_cpu(tmp_path):
    """Reruns, the embedding-gradient chunk and 2 gloo ranks: the same
    training fingerprints, each from a fresh process."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("REPRO_TRACE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.audit", "--out",
         str(tmp_path), "--device", "cpu", "--skip-groupby",
         "--skip-stream", "--timeout", "240"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    summary = json.loads((tmp_path / "audit_summary.json").read_text())
    assert (summary["status"], summary["train"]) == ("pass", "identical")
    assert summary["groupby"] is None and summary["stream"] is None
    fps = [fp.read_fingerprints(str(tmp_path / f"fp_train_{tag}.json"))
           for tag, _ in audit.TRAIN_VARIANTS]
    assert {"loss_trajectory", "params", "opt"} <= set(fps[0])
    assert fps[2][fp.MANIFEST_KEY]["mesh"]["data"] == 2
    for other in fps[1:]:
        assert fp.diff_fingerprints(fps[0], other) == []
    assert "train=identical" in proc.stdout


def test_audit_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        audit.main(["--worker", "groupby", "--out", str(tmp_path),
                    "--n", "64"])


def _chrome_events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


def test_spans_enter_the_profilers_timeline(tmp_path):
    """Under a profiler the spans are ``user_annotation`` events, the
    child inside its parent and the torch operators inside the child;
    under ``REPRO_TRACE`` the records share their outermost span's id."""
    x = torch.arange(64, dtype=torch.float32)
    act = torch.profiler.ProfilerActivity
    trace.disable()
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        with trace.span("test.outer"):
            with trace.span("test.inner") as sp:
                assert sp.set(rows=1) is sp
                (x * 2).sum()
    events = _chrome_events(prof, tmp_path)
    marks = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("test.")}
    assert set(marks) == {"test.outer", "test.inner"}
    outer, inner = marks["test.outer"], marks["test.inner"]

    def within(a, b):
        return b["ts"] <= a["ts"] and \
            a["ts"] + a["dur"] <= b["ts"] + b["dur"]

    assert within(inner, outer)
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"] in ("aten::mul", "aten::sum")]
    assert {op["name"] for op in ops} == {"aten::mul", "aten::sum"}
    assert all(within(op, inner) for op in ops)

    trace.configure(None)
    try:
        with torch.profiler.profile(activities=[act.CPU]) as prof:
            with trace.span("test.outer"):
                with trace.span("test.inner"):
                    trace.event("test.point")
            with trace.span("test.next"):
                pass
        records = trace.events()
    finally:
        trace.disable()
    by = {r["name"]: r for r in records}
    outer_id = by["test.outer"]["span_id"]
    assert by["test.outer"]["root_id"] == outer_id
    assert by["test.inner"]["root_id"] == outer_id
    assert by["test.point"]["root_id"] == outer_id
    assert by["test.next"]["root_id"] == by["test.next"]["span_id"]
    names = {e["name"] for e in _chrome_events(prof, tmp_path)
             if e.get("cat") == "user_annotation"}
    assert {"test.outer", "test.inner", "test.next"} <= names


def test_span_is_the_shared_null_span_when_off():
    trace.disable()
    assert trace.span("test.off", rows=3) is trace._NULL_SPAN
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert trace.span("test.off") is not trace._NULL_SPAN
    assert trace.span("test.off") is trace._NULL_SPAN


def _host_reads():
    return {r["labels"]["site"]: r["value"]
            for r in metrics.to_dict().get(metrics.HOST_READS, [])}


def test_groupby_counts_its_host_reads():
    """``levels="auto"`` reads the level window's two ends and, where it
    spans more than one level, whether some chunk prunes more: 3 reads;
    ``check_finite`` reads two more; a given window reads none."""
    from repro_torch.ops import groupby_agg
    gen = torch.Generator().manual_seed(5)
    v = torch.randn(4096, 2, generator=gen) * \
        torch.tensor([1.0, 1e-6]).expand(4096, 2)
    v[:2048] *= 1e6
    k = torch.randint(0, 9, (4096,), generator=gen)
    aggs = [("sum", 0), ("mean", 1), "count"]

    def reads(**kw):
        before = _host_reads()
        groupby_agg(v, k, 9, aggs, device="cpu", **kw)
        after = _host_reads()
        return {s: n - before.get(s, 0.0) for s, n in after.items()
                if n != before.get(s, 0.0)}

    assert reads() == {"prescan.lo": 1, "prescan.hi": 1,
                       "prescan.chunk_skip": 1}
    assert reads(check_finite=True) == {
        "prescan.lo": 1, "prescan.hi": 1, "prescan.chunk_skip": 1,
        "columns.finite_inputs": 1, "columns.finite_columns": 1}
    assert reads(levels=None) == {}

"""The GROUPBY engine as an explicit algebra: partial / merge / finalize.

* :func:`partial_agg` — aggregate a batch of rows into a
  :class:`PartialState`: the ``(G, ncols, L)`` accumulator table on the
  batch's own per-column lattice, stacked MIN/MAX columns, and a row count;
* :func:`merge` — combine two states bitwise-associatively (demotion onto
  the pairwise-max lattice, integer add, canonical renorm);
* :func:`finalize` — the pure deterministic function from a state to the
  result dict.

``groupby_agg`` is ``finalize(partial_agg(...))``; the stream stores
(:mod:`repro_torch.stream`) run :class:`PartialPipeline` per micro-batch.
States carry the same
table dtypes and the same :class:`AggSignature` JSON as the JAX package's,
so states move between the two packages unchanged
(:mod:`repro_torch.interop`).

MIN/MAX reduce over an order-preserving integer key of the float bits
(``-0.0`` below ``+0.0``), which is exact and independent of row order: a
group holding both zeros gets ``+0.0`` from MAX and ``-0.0`` from MIN, as
the JAX package's ``segment_max``/``segment_min`` give.  A group holding a
NaN gets that NaN; empty groups get the ±inf identities.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import accumulator as acc_mod
from repro_torch.core import aggregates
from repro_torch.core import prescan
from repro_torch.core.accumulator import ReproAcc
from repro_torch.core.types import ReproSpec, dtype_name, float_spec
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.ops.plan import plan_groupby

__all__ = [
    "AGG_KINDS", "AggSignature", "PartialState", "PartialPipeline",
    "agg_name", "partial_agg", "merge", "merge_all", "finalize",
    "empty_partial", "pipeline_for", "state_nbytes",
]

AGG_KINDS = ("sum", "count", "mean", "var", "std", "min", "max", "sum_prod")


# ---------------------------------------------------------------------------
# aggregate compilation (the engine's front end)
# ---------------------------------------------------------------------------

def _normalize(aggs):
    """Accept 'sum' / ('sum', col) / ('sum_prod', i, j) forms -> tuples."""
    norm = []
    for a in aggs:
        if isinstance(a, str):
            a = (a,) if a in ("count",) else (a, 0)
        a = tuple(a)
        kind = a[0]
        if kind == "avg":
            kind, a = "mean", ("mean", *a[1:])
        if kind == "count":
            a = ("count",)
        elif kind == "sum_prod":
            if len(a) != 3:
                raise ValueError(f"sum_prod takes two columns, got {a!r}")
        elif len(a) != 2:
            raise ValueError(f"aggregate {a!r} takes exactly one column")
        if kind not in AGG_KINDS:
            raise ValueError(f"unknown aggregate {kind!r}; want {AGG_KINDS}")
        norm.append(a)
    return norm


def agg_name(a) -> str:
    """Canonical result key: 'sum(0)', 'count(*)', 'sum_prod(0,1)', ..."""
    a = _normalize([a])[0]
    if a[0] == "count":
        return "count(*)"
    return f"{a[0]}({','.join(str(c) for c in a[1:])})"


def _compile(aggs):
    """Compile aggregates to (names, accumulator columns, finalize plans),
    deduplicating the accumulator columns."""
    norm = _normalize(aggs)
    cols, index = [], {}

    def need(c):
        if c not in index:
            index[c] = len(cols)
            cols.append(c)
        return index[c]

    plans = []
    for a in norm:
        kind = a[0]
        if kind == "sum":
            plans.append(("sum", need(("col", a[1]))))
        elif kind == "sum_prod":
            plans.append(("sum", need(("prod", a[1], a[2]))))
        elif kind == "count":
            plans.append(("count", need(("ones",))))
        elif kind == "mean":
            plans.append(("mean", need(("col", a[1])), need(("ones",))))
        elif kind in ("var", "std"):
            plans.append((kind, need(("col", a[1])), need(("sq", a[1])),
                          need(("ones",))))
        else:  # min / max: exact as-is, no accumulator column
            plans.append((kind, a[1]))
    return [agg_name(a) for a in norm], cols, plans


def _as_matrix(values, spec: ReproSpec, device) -> torch.Tensor:
    v = torch.as_tensor(values).to(device=device, dtype=spec.dtype)
    if v.ndim == 1:
        v = v[:, None]
    if v.ndim != 2:
        raise ValueError(f"groupby_agg expects values (n,) or (n, C), "
                         f"got shape {tuple(v.shape)}")
    return v


def _build_columns(v: torch.Tensor, cols, spec: ReproSpec) -> torch.Tensor:
    """Materialize the stacked accumulator-column matrix (n, ncols)."""
    X = torch.empty((v.shape[0], len(cols)), dtype=spec.dtype,
                    device=v.device)
    for j, c in enumerate(cols):
        if c[0] == "col":
            X[:, j] = v[:, c[1]]
        elif c[0] == "sq":
            torch.mul(v[:, c[1]], v[:, c[1]], out=X[:, j])
        elif c[0] == "prod":
            torch.mul(v[:, c[1]], v[:, c[2]], out=X[:, j])
        else:  # ("ones",)
            X[:, j] = 1
    return X


def _minmax_cols(plans):
    return sorted({p[1] for p in plans if p[0] in ("min", "max")})


def _col_name(c) -> str:
    if c[0] == "ones":
        return "ones"
    return f"{c[0]}({','.join(str(i) for i in c[1:])})"


# ---------------------------------------------------------------------------
# the aggregate signature: what makes two states mergeable
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AggSignature:
    """Static identity of a partial state: two states merge iff their
    signatures are equal (same aggregates, group count and accumulator
    format)."""

    aggs: tuple          # normalized aggregate tuples
    num_segments: int
    spec: ReproSpec

    @classmethod
    def build(cls, aggs, num_segments: int,
              spec: ReproSpec | None) -> "AggSignature":
        return cls(aggs=tuple(_normalize(aggs)),
                   num_segments=int(num_segments), spec=spec or ReproSpec())

    @property
    def compiled(self):
        """(names, accumulator columns, finalize plans) — cached."""
        return _compiled(self)

    @property
    def ncols(self) -> int:
        return len(self.compiled[1])

    @property
    def minmax(self):
        return _minmax_cols(self.compiled[2])

    def to_json(self) -> dict:
        """JSON form, byte-identical to the JAX package's."""
        return {"aggs": [list(a) for a in self.aggs],
                "num_segments": self.num_segments,
                "dtype": dtype_name(self.spec.dtype),
                "L": self.spec.L, "W": self.spec.W}

    @classmethod
    def from_json(cls, d: dict) -> "AggSignature":
        spec = ReproSpec(dtype=float_spec(d["dtype"]).dtype,
                         L=int(d["L"]), W=int(d["W"]))
        return cls.build([tuple(a) for a in d["aggs"]],
                         d["num_segments"], spec)


@functools.lru_cache(maxsize=256)
def _compiled(sig: AggSignature):
    return _compile(sig.aggs)


# ---------------------------------------------------------------------------
# the partial state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartialState:
    """A mergeable partial aggregate over some subset of the rows.

    ``table`` — the integer accumulator table ``(G, ncols, L)``;
    ``minv``/``maxv`` — stacked exact MIN/MAX columns ``(G, nmm)`` with the
    ±inf identities on untouched groups; ``rows`` — int32 row count.
    """

    table: ReproAcc
    minv: torch.Tensor
    maxv: torch.Tensor
    rows: torch.Tensor
    sig: AggSignature

    @property
    def spec(self) -> ReproSpec:
        return self.sig.spec

    @property
    def num_segments(self) -> int:
        return self.sig.num_segments


def empty_partial(num_segments: int, aggs=("sum",),
                  spec: ReproSpec | None = None,
                  device=None) -> PartialState:
    """The identity of :func:`merge`: an all-zero table at the bottom of
    the lattice, ±inf MIN/MAX identities, zero rows."""
    dev = resolve_device(device)
    sig = AggSignature.build(aggs, num_segments, spec)
    spec = sig.spec
    g, nmm = sig.num_segments, len(sig.minmax)
    return PartialState(
        table=acc_mod.zeros(spec, (g, sig.ncols), device=dev),
        minv=torch.full((g, nmm), torch.inf, dtype=spec.dtype, device=dev),
        maxv=torch.full((g, nmm), -torch.inf, dtype=spec.dtype, device=dev),
        rows=torch.zeros((), dtype=torch.int32, device=dev),
        sig=sig)


# ---------------------------------------------------------------------------
# exact MIN/MAX over an order-preserving integer key
# ---------------------------------------------------------------------------

def _order_key(x: torch.Tensor) -> torch.Tensor:
    """Signed-int key with key(a) < key(b) iff a < b in the total order
    -inf < ... < -0.0 < +0.0 < ... < +inf (NaNs are handled separately)."""
    idt = float_spec(x.dtype).int_dtype
    b = x.view(idt)
    flip = torch.iinfo(idt).max
    return torch.where(b < 0, b ^ flip, b)


def _from_key(key: torch.Tensor, dtype) -> torch.Tensor:
    flip = torch.iinfo(key.dtype).max
    return torch.where(key < 0, key ^ flip, key).view(dtype)


def _nan_pick(x: torch.Tensor, nan: torch.Tensor):
    """Per-candidate NaN choice: where ``nan`` marks NaN entries, the one
    with the largest bit pattern (as a signed int) — order-free."""
    idt = float_spec(x.dtype).int_dtype
    lowest = torch.iinfo(idt).min          # -0.0: never a NaN's bits
    return torch.where(nan, x.view(idt), lowest)


def _segment_extreme(v: torch.Tensor, keys: torch.Tensor, num_segments: int,
                     largest: bool) -> torch.Tensor:
    """Exact, order-independent segment MAX (``largest``) or MIN of the
    columns of ``v`` (n, c) -> (G, c)."""
    idt = float_spec(v.dtype).int_dtype
    ident = torch.tensor(-torch.inf if largest else torch.inf, dtype=v.dtype)
    init = _order_key(ident).item()
    idx = keys.to(torch.int64)[:, None].expand(v.shape)
    out = torch.full((num_segments, v.shape[1]), init, dtype=idt,
                     device=v.device)
    out.scatter_reduce_(0, idx, _order_key(v),
                        "amax" if largest else "amin", include_self=True)
    res = _from_key(out, v.dtype)
    isnan = torch.isnan(v)
    lowest = torch.iinfo(idt).min
    nanbits = torch.full_like(out, lowest)
    nanbits.scatter_reduce_(0, idx, _nan_pick(v, isnan), "amax",
                            include_self=True)
    return torch.where(nanbits != lowest, nanbits.view(v.dtype), res)


def _extreme(a: torch.Tensor, b: torch.Tensor, largest: bool):
    """Elementwise exact MAX/MIN of two stacked columns under the same
    order (``-0.0 < +0.0``) and NaN choice as :func:`_segment_extreme`."""
    ka, kb = _order_key(a), _order_key(b)
    res = _from_key(torch.maximum(ka, kb) if largest
                    else torch.minimum(ka, kb), a.dtype)
    na, nb = torch.isnan(a), torch.isnan(b)
    nanbits = torch.maximum(_nan_pick(a, na), _nan_pick(b, nb))
    return torch.where(na | nb, nanbits.view(a.dtype), res)


# ---------------------------------------------------------------------------
# non-finite contract: opt-in loud failure
# ---------------------------------------------------------------------------

def _check_finite(v: torch.Tensor, X: torch.Tensor, cols) -> None:
    """Fail loudly on ±inf/NaN inputs and on derived columns that overflow
    (e.g. ``var`` squaring a finite float32 past float32-max)."""
    bad = ~torch.isfinite(v)
    obs_metrics.host_read("columns.finite_inputs")
    if bool(bad.any()):
        where = sorted(set(torch.nonzero(bad)[:, 1].tolist()))
        raise FloatingPointError(
            f"non-finite input values in column(s) {where}: the "
            "reproducibility contract covers finite inputs only")
    badx = ~torch.isfinite(X)
    obs_metrics.host_read("columns.finite_columns")
    if bool(badx.any()):
        names = [_col_name(cols[j])
                 for j in sorted(set(torch.nonzero(badx)[:, 1].tolist()))]
        raise FloatingPointError(
            f"derived accumulator column(s) {names} overflow to non-finite "
            "values from finite inputs (e.g. var squaring past "
            "float32-max); strategies legitimately diverge there")


# ---------------------------------------------------------------------------
# stage 1: partial aggregation
# ---------------------------------------------------------------------------

def _resolve_levels(levels, X: torch.Tensor, e1: torch.Tensor,
                    spec: ReproSpec):
    """Turn the ``levels`` request into (static window | None, chunk_skip).

    ``"auto"`` = the prescan pass: per-chunk, per-column exponent stats;
    the union of the live windows becomes the static window, and
    ``chunk_skip`` reports whether some chunk could prune more than the
    union (magnitude-heterogeneous data).
    """
    if levels is None:
        return None, False
    if levels != "auto":
        return prescan.check_levels(levels, spec), False
    if X.shape[0] == 0:
        return (0, 1), False                    # empty input: all-zero table
    probe = aggregates.default_chunk("scatter", spec)
    stats = prescan.chunk_stats(X, probe, spec)              # (nblk, ncols)
    lo_a, hi_a = prescan.level_window(stats, e1[None, :], spec)
    lo = int(lo_a.min())
    obs_metrics.host_read("prescan.lo")
    hi = int(hi_a.max())
    obs_metrics.host_read("prescan.hi")
    if lo >= hi:
        lo, hi = 0, 1                            # degenerate: all-zero input
    chunk_skip = False
    if hi - lo > 1:
        chunk_skip = bool(
            lo_a.reshape(lo_a.shape[0], -1).amin(dim=1).amax() > lo)
        obs_metrics.host_read("prescan.chunk_skip")
    return (lo, hi), chunk_skip


def _emit_prescan_stats(n, ncols, spec: ReproSpec, lv, chunk_skip, plan):
    """Record what the prescan proved (no-op when observability is off)."""
    l_eff = prescan.window_length(lv, spec)
    chunks = -(-int(n) // plan.chunk) if plan.chunk else 0
    obs_trace.event("groupby.prescan_stats", n=int(n), ncols=int(ncols),
                    L=spec.L, L_eff=l_eff,
                    levels=list(lv) if lv is not None else None,
                    chunk_skip=bool(chunk_skip), chunk=plan.chunk,
                    chunks=chunks)
    obs_metrics.counter("repro_groupby_rows_total").inc(int(n))
    obs_metrics.counter("repro_groupby_levels_pruned_total").inc(
        spec.L - l_eff)


def partial_agg(values, keys, num_segments: int, aggs=("sum",),
                spec: ReproSpec | None = None, method: str = "auto",
                chunk: int | None = None, levels="auto",
                check_finite: bool = False, device=None) -> PartialState:
    """Aggregate one batch of rows into a mergeable :class:`PartialState`.

    Arguments as in :func:`repro_torch.ops.groupby_agg`.  The state's
    lattice is the tightest this batch admits (per-column ``required_e1``);
    :func:`merge` aligns mismatched lattices exactly.
    """
    return _partial_agg(values, keys, num_segments, aggs, spec, method,
                        chunk, levels, check_finite, device)


def _batch_lattice(X: torch.Tensor, spec: ReproSpec) -> torch.Tensor:
    return acc_mod.required_e1(X, spec, axis=0)


def _partial_agg(values, keys, num_segments: int, aggs, spec, method, chunk,
                 levels, check_finite, device,
                 lattice=_batch_lattice) -> PartialState:
    """Stage 1 with the lattice as a parameter: ``lattice(X, spec)`` gives
    the per-column e1 to extract on (:mod:`repro_torch.ops.sharded` agrees
    it across processes).  The level window is proved against that
    lattice, on this batch's rows."""
    dev = resolve_device(device)
    sig = AggSignature.build(aggs, num_segments, spec)
    spec = sig.spec
    names, cols, plans = sig.compiled
    with obs_trace.span("groupby.columns", ncols=len(cols)) as sp:
        v = _as_matrix(values, spec, dev)
        keys = torch.as_tensor(keys).to(device=dev, dtype=torch.int32) \
            .reshape(-1)
        if v.shape[0] != keys.shape[0]:
            raise ValueError("values and keys disagree on the row count")
        X = _build_columns(v, cols, spec)
        if check_finite:
            _check_finite(v, X, cols)
        sp.set(n=int(X.shape[0]))
    ncols = X.shape[1]

    if ncols:
        with obs_trace.span("groupby.prescan", n=int(X.shape[0]),
                            ncols=ncols) as sp:
            e1 = lattice(X, spec)                            # per-column
            lv, chunk_skip = _resolve_levels(levels, X, e1, spec)
            sp.set(levels=list(lv) if lv is not None else None,
                   chunk_skip=bool(chunk_skip))
        with obs_trace.span("groupby.plan"):
            plan = plan_groupby(int(X.shape[0]), num_segments, spec,
                                ncols=ncols, backend=dev.type, method=method,
                                chunk=chunk, levels=lv)
            _emit_prescan_stats(X.shape[0], ncols, spec, lv, chunk_skip,
                                plan)
        with obs_trace.span("groupby.aggregate", method=plan.method,
                            chunk=plan.chunk, buckets=plan.buckets,
                            n=int(X.shape[0]), G=int(num_segments)):
            table = aggregates.segment_table(
                X, keys, num_segments, spec, method=plan.method, e1=e1,
                chunk=plan.chunk, levels=lv, chunk_skip=chunk_skip,
                num_buckets=plan.buckets if plan.method in ("sort", "radix")
                else None, device=dev)
    else:
        table = acc_mod.zeros(spec, (num_segments, 0), device=dev)

    mm = sig.minmax
    if mm:
        with obs_trace.span("groupby.minmax", ncols=len(mm)):
            vm = v[:, mm]
            minv = _segment_extreme(vm, keys, num_segments, largest=False)
            maxv = _segment_extreme(vm, keys, num_segments, largest=True)
    else:
        minv = torch.zeros((num_segments, 0), dtype=spec.dtype, device=dev)
        maxv = torch.zeros((num_segments, 0), dtype=spec.dtype, device=dev)

    return PartialState(table=table, minv=minv, maxv=maxv,
                        rows=torch.tensor(v.shape[0], dtype=torch.int32,
                                          device=dev), sig=sig)


# ---------------------------------------------------------------------------
# stage 2: the associative merge
# ---------------------------------------------------------------------------

def _check_sig(a: PartialState, b: PartialState):
    if a.sig != b.sig:
        raise ValueError(
            "cannot merge partial states with different signatures: "
            f"{a.sig} vs {b.sig}")


def merge(a: PartialState, b: PartialState) -> PartialState:
    """Bitwise-associative, commutative merge of two partial states:
    ``merge(partial(A), partial(B)) == partial(A ++ B)`` bit for bit."""
    _check_sig(a, b)
    return PartialState(
        table=acc_mod.merge(a.table, b.table, a.spec),
        minv=_extreme(a.minv, b.minv, largest=False),
        maxv=_extreme(a.maxv, b.maxv, largest=True),
        rows=a.rows + b.rows,
        sig=a.sig)


def merge_all(states) -> PartialState:
    """Exact k-way merge: one demotion onto the max lattice plus one
    integer tree reduction — bit-identical to any pairwise fold."""
    states = list(states)
    if not states:
        raise ValueError("merge_all needs at least one state")
    for s in states[1:]:
        _check_sig(states[0], s)
    if len(states) == 1:
        return states[0]
    minv = functools.reduce(lambda x, y: _extreme(x, y, False),
                            [s.minv for s in states])
    maxv = functools.reduce(lambda x, y: _extreme(x, y, True),
                            [s.maxv for s in states])
    rows = functools.reduce(lambda x, y: x + y, [s.rows for s in states])
    return PartialState(
        table=acc_mod.merge_all([s.table for s in states], states[0].spec),
        minv=minv, maxv=maxv, rows=rows, sig=states[0].sig)


# ---------------------------------------------------------------------------
# stage 3: finalize
# ---------------------------------------------------------------------------

def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root on any device.

    ``torch.sqrt`` on the CPU is not correctly rounded (about 0.7% of random
    float32 and float64 inputs come out one ulp off), while the JAX package's
    is, so STD would differ in its last bit.  float32: a float64 square
    root gives a candidate within one ulp, which the exact float64 test
    against the neighbouring midpoints (25-bit numbers, whose squares are
    exact) then corrects.  float64: the host's IEEE square root.
    """
    if x.dtype != torch.float32:
        obs_metrics.host_read("finalize.sqrt")
        return torch.from_numpy(np.sqrt(x.cpu().numpy())).to(x.device)
    xd = x.double()
    y = torch.sqrt(xd).float()
    up = torch.nextafter(y, y.new_tensor(torch.inf))
    dn = torch.nextafter(y, y.new_tensor(-torch.inf))
    hi = (y.double() + up.double()) * 0.5
    lo = (y.double() + dn.double()) * 0.5
    y = torch.where(xd > hi * hi, up, y)
    return torch.where((lo > 0) & (xd < lo * lo), dn, y)


def _finalize_plans(names, plans, sums, mins, maxs, spec: ReproSpec):
    """Derive every requested aggregate from the finalized table with fixed
    elementwise formulas, one eager operation at a time.  Empty groups
    yield NaN for MEAN/VAR/STD."""
    nan = torch.tensor(torch.nan, dtype=spec.dtype, device=sums.device)
    out = {}
    for name, p in zip(names, plans):
        kind = p[0]
        if kind in ("sum", "count"):
            r = sums[:, p[1]]
        elif kind == "mean":
            s, cnt = sums[:, p[1]], sums[:, p[2]]
            r = torch.where(cnt > 0, s / torch.where(cnt > 0, cnt, 1), nan)
        elif kind in ("var", "std"):
            s, s2, cnt = sums[:, p[1]], sums[:, p[2]], sums[:, p[3]]
            safe = torch.where(cnt > 0, cnt, 1)
            mean = s / safe
            r = s2 / safe - mean * mean                    # population var
            # max(r, +0.0) as the JAX package spells it: NaN stays NaN and
            # every r <= 0, -0.0 included, becomes +0.0
            r = torch.where((r > 0) | torch.isnan(r), r, 0.0)
            if kind == "std":
                r = _sqrt_rn(r)
            r = torch.where(cnt > 0, r, nan)
        elif kind == "min":
            r = mins[p[1]]
        else:
            r = maxs[p[1]]
        out[name] = r
    return out


def finalize(state: PartialState) -> dict:
    """Deterministic conversion of a state to the finalized result dict: a
    pure function of the canonical state, in eager torch operations (no
    kernel fusion that could contract ``s2/n - mean*mean``)."""
    sig = state.sig
    spec = sig.spec
    names, cols, plans = sig.compiled
    with obs_trace.span("groupby.finalize"):
        sums = acc_mod.finalize(state.table, spec)           # (G, ncols)
        mm = sig.minmax
        mins = {j: state.minv[:, i] for i, j in enumerate(mm)}
        maxs = {j: state.maxv[:, i] for i, j in enumerate(mm)}
        return _finalize_plans(names, plans, sums, mins, maxs, spec)


# ---------------------------------------------------------------------------
# the streaming prepare stage
# ---------------------------------------------------------------------------

def state_nbytes(state: PartialState) -> int:
    """Bytes held by a state's leaves (backpressure accounting)."""
    return sum(t.numel() * t.element_size()
               for t in (state.table.k, state.table.C, state.table.e1,
                         state.minv, state.maxv, state.rows))


class PartialPipeline:
    """:func:`partial_agg` bound to one :class:`AggSignature`, device and
    configuration: the prepare stage a stream store runs per micro-batch.

    The JAX package compiles the tail of this stage (``segment_table`` plus
    MIN/MAX) per plan decision; here nothing is compiled — the stage runs
    :func:`partial_agg`'s own code (column build, ``required_e1``, the
    level prescan, the planner, ``segment_table`` with the hand-written
    kernels on the card, MIN/MAX) eagerly, so a stream's states are the
    one-shot path's bit for bit by construction.  The object is what
    stores and shards share through :func:`pipeline_for`.
    """

    def __init__(self, sig: AggSignature, method: str = "auto",
                 levels="auto", check_finite: bool = False, device=None):
        self.sig = sig
        self.method = method
        self.levels = tuple(levels) if isinstance(levels, list) else levels
        self.check_finite = check_finite
        self.device = resolve_device(device)

    def __call__(self, values, keys) -> PartialState:
        """Aggregate one batch: ``partial_agg`` with this configuration."""
        sig = self.sig
        return _partial_agg(values, keys, sig.num_segments, sig.aggs,
                            sig.spec, self.method, None, self.levels,
                            self.check_finite, self.device)


@functools.lru_cache(maxsize=64)
def pipeline_for(sig: AggSignature, method: str = "auto", levels="auto",
                 check_finite: bool = False,
                 device=None) -> PartialPipeline:
    """The shared :class:`PartialPipeline` for a configuration (stores and
    shards with equal arguments share one)."""
    return PartialPipeline(sig, method=method, levels=levels,
                           check_finite=check_finite, device=device)

"""Streaming incremental aggregation on the partial/merge/finalize algebra,
on the card unless a store is given ``device="cpu"``.

* :mod:`repro_torch.stream.store` — :class:`StreamStore`: a persistent
  merged state ingesting micro-batch deltas, queryable anytime,
  snapshot/restore verifiably bit-exact;
* :mod:`repro_torch.stream.window` — :class:`WindowedStore`: event-time
  windows as a ring of mergeable partials;
* :mod:`repro_torch.stream.sharded` — :class:`ShardedStreamStore`: N shard
  stores whose query-time ``merge_all`` equals a single store bit for bit;
* :mod:`repro_torch.stream.service` — the asyncio NDJSON endpoint with
  pipelined ingest and backpressure;
* :mod:`repro_torch.stream.wal` — :class:`WriteAheadLog`: the JAX
  package's framed, sha256-verified delta log, byte for byte;
* :mod:`repro_torch.stream.replica` — :class:`ReplicatedStore`: a logging
  primary plus WAL-tailing followers, failover gated on fingerprints.

The headline invariant: the same rows delivered as any micro-batches, in
any order, across any shard count, crash plus recovery or failover,
produce a store whose table and results fingerprints equal the one-shot
``groupby_agg`` over the concatenated rows — and the JAX package's store
fed the same batches.
"""
from repro_torch.stream.store import StreamStore  # noqa: F401
from repro_torch.stream.sharded import ShardedStreamStore  # noqa: F401
from repro_torch.stream.window import WindowedStore  # noqa: F401
from repro_torch.stream.service import (  # noqa: F401
    Backpressure, StreamService, serve,
)
from repro_torch.stream.wal import (  # noqa: F401
    DedupIndex, WalError, WalReader, WalUnavailable, WriteAheadLog,
)
from repro_torch.stream.replica import (  # noqa: F401
    Follower, PromotionError, ReplicatedStore,
)

__all__ = ["StreamStore", "ShardedStreamStore", "WindowedStore",
           "StreamService", "Backpressure", "serve",
           "WriteAheadLog", "WalReader", "WalError", "WalUnavailable",
           "DedupIndex", "Follower", "ReplicatedStore", "PromotionError"]

"""The program entry of a GROUP BY over rows partitioned across ranks:
``repro_torch.ops.sharded.sharded_groupby_agg``.

Each rank aggregates its own rows (``partial_agg``), the ranks agree on the
lattice with an all-reduce MAX, merge exactly with
``core/collectives.py::repro_psum`` and finalize: every rank returns the
same answer, that of ``groupby_agg`` over all ranks' rows.  It needs the
ranks' process group, so it runs in a cell of more than one chip, or
through ``ranks.launch`` in a world of one.
"""


def build(device, group=None):
    if group is None:
        raise ValueError("sharded_groupby_agg merges across ranks: it needs "
                         "their process group (a cell of more than one "
                         "chip, or ranks.launch)")
    from repro_torch.ops.sharded import sharded_groupby_agg

    def entry(values, keys, groups, aggs):
        return sharded_groupby_agg(values, keys, groups, aggs, group=group,
                                   device=device)

    return entry

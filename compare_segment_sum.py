#!/usr/bin/env python3
"""Ways to sum graph messages per receiver on the card, timed side by side.

Run from the repository root on a GPU machine::

    python3 compare_segment_sum.py

At the AMGNet example's graph (64 nodes, 4 neighbours) and a 4096-node
kNN graph (4 neighbours), hidden 64, each way computes the segment sum of
(E, 64) edge rows by receiver:

* ``port``: ``nn/segment.py::segment_sum`` (the ``embedding_bag`` way
  below, in its ``autograd.Function``);
* ``padded``: the port's first design, ``cat([rows, 0])[table].sum(1)``
  over a (nodes, max in-degree) table of each receiver's edges in
  ascending order, padded with the zero row;
* ``embedding_bag``: ``F.embedding_bag`` of the edges sorted by receiver
  (stable), one bag a receiver (``offsets`` its first edge), mode "sum":
  one kernel that walks each bag's rows in order;
* ``segment_reduce``: ``torch.segment_reduce`` of the sorted rows with the
  per-receiver lengths;
* ``index_add``: ``zeros.index_add_`` (float atomics: the order changes
  from call to call).

For each: whether two calls are bitwise equal, the largest error against
a float64 sum over the largest magnitude, and the device ms a call (20
calls captured in one CUDA graph, the replay timed with CUDA events).
Prints the card's name and power limit, then one JSON line a graph.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
GRAPHS = {"amgnet": (64, 4), "knn4096": (4096, 4)}
HIDDEN = 64


def main() -> int:
    if not torch.cuda.is_available():
        print("compare_segment_sum: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    from paddlescience_torch.data.dataset.domain_dataset import make_synthetic_graph
    from paddlescience_torch.nn import segment as seg

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for tag, (n, k) in GRAPHS.items():
        _, _, _, r, _ = make_synthetic_graph(np.random.default_rng(0), n, k, 5, 3, 3)
        e = torch.randn((len(r), HIDDEN), generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
        plan = seg.segments(r, n)
        order = np.argsort(r, kind="stable")
        starts = np.concatenate([[0], np.cumsum(plan.counts)[:-1]])
        order_t = torch.as_tensor(order, device="cuda")
        offsets_t = torch.as_tensor(starts, device="cuda")
        lengths_t = torch.as_tensor(plan.counts, device="cuda")
        degree = int(plan.counts.max())
        rank = np.arange(len(r)) - starts[np.asarray(r)[order]]
        table = np.full((n, degree), len(r), np.int64)  # each receiver's edges in order, padded with the zero row
        table[np.asarray(r)[order], rank] = order
        table_t = torch.as_tensor(table.reshape(-1), device="cuda")
        r_t = torch.as_tensor(r, device="cuda").long()

        def padded():
            rows = torch.cat([e, e.new_zeros((1, HIDDEN))], 0)
            return rows.index_select(0, table_t).view(n, degree, HIDDEN).sum(1)

        ways = {
            "port": lambda: seg.segment_sum(e, r, n),  # nn/segment.py: embedding_bag in an autograd.Function
            "padded": padded,
            "embedding_bag": lambda: F.embedding_bag(order_t, e, offsets_t, mode="sum"),
            "segment_reduce": lambda: torch.segment_reduce(e.index_select(0, order_t), "sum", lengths=lengths_t,
                                                           unsafe=True),
            "index_add": lambda: e.new_zeros((n, HIDDEN)).index_add_(0, r_t, e),
        }
        ref = torch.zeros((n, HIDDEN), dtype=torch.float64, device="cuda").index_add_(0, r_t, e.double())
        report = {"graph": tag, "nodes": n, "edges": len(r), "hidden": HIDDEN, "max_in_degree": degree}
        for name, fn in ways.items():
            a, b = fn(), fn()
            report[name] = {"bitwise_two_calls": bool(torch.equal(a, b)),
                            "err_vs_float64": float((a.double() - ref).abs().max() / ref.abs().max()),
                            "device_ms": chip_smoke.graph_ms(fn)}
        print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

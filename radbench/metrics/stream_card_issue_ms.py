"""Stream: the host's issue time per card and chunk, in ms, on the card
that takes the most.

For each card i, the program's ``shards.card<i>`` spans
(``parallel/mesh.map_shards``: the card's piece of the step, its
``capture.call`` within) that lie inside a ``stream.dispatch`` span, and
its ``stream.fetch.card<i>`` spans (``parallel/scale._PinnedRing.fetch``:
the card's copies to host memory queued), totalled over the traced
sub-window and divided by its chunks (passes times ``n_chunks``); the
largest over the cards.  The ``shards.card<i>`` spans of the chunk
builder, which the stream calls outside ``stream.dispatch``, are left
out, as ``stream_issue_share`` leaves them out.  Each card's value goes
to standard error."""
import sys
from bisect import bisect_right
from collections import defaultdict

SHARDS, FETCH = "shards.card", "stream.fetch.card"


def read(run):
    w = run.trace
    if w is None or not w.units:
        return None
    events = [e for e in w.host_events if w.t0 <= e["ts"] < w.t1]
    dispatch = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e["name"] == "stream.dispatch")
    starts = [a for a, _ in dispatch]

    def in_dispatch(ts):
        k = bisect_right(starts, ts) - 1
        return k >= 0 and ts < dispatch[k][1]

    cards = defaultdict(float)
    for e in events:
        name = e["name"]
        if name.startswith(FETCH):
            cards[int(name[len(FETCH):])] += e["dur"]
        elif name.startswith(SHARDS) and in_dispatch(e["ts"]):
            cards[int(name[len(SHARDS):])] += e["dur"]
    if not cards:
        return None
    chunks = w.units * run.cell["params"]["n_chunks"]
    ms = {i: us / 1e3 / chunks for i, us in sorted(cards.items())}
    print("# stream_card_issue_ms per card: " + ", ".join(
        f"card{i} {v:.6f}" for i, v in ms.items()), file=sys.stderr)
    return max(ms.values())

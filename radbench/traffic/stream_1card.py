"""The ``stream`` kind (``traffic/stream.py``) unchanged, under a name of
its own for a cell whose passes are held on one card.

BENCHMARK.json gives each pair of configuration and traffic once, and
``l60_stream_4card_c262k`` already runs ``ecckd12_l60_rfmip`` under
``stream``; the one-card cell (``l60_stream_1card``) runs the same
configuration and the same passes, so its traffic is this alias.  The
cell's file sets the chunk, the passes in flight, the outputs and the
checks, as a ``stream`` cell's does.
"""
from radbench.traffic.stream import Traffic  # noqa: F401

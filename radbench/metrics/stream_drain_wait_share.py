"""Stream: the share of the passes' wall time, in %, that the host waits
for a chunk's copies to host memory: ``stream_chunks``' ``drain_wait_s``
over its ``wall_s``, summed over the window's passes outside the traced
sub-window."""


def read(run):
    c = run.window.get("counters", {})
    if not c.get("wall_s"):
        return None
    return 100.0 * c["drain_wait_s"] / c["wall_s"]

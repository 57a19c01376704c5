"""Stream: the share of the passes' wall time, in %, that the host spends
issuing work: ``parallel.scale.stream_chunks``' own ``dispatch_s`` plus
``d2h_issue_s``, over its ``wall_s``, summed over the window's passes
outside the traced sub-window."""


def read(run):
    c = run.window.get("counters", {})
    if not c.get("wall_s"):
        return None
    return 100.0 * (c["dispatch_s"] + c["d2h_issue_s"]) / c["wall_s"]

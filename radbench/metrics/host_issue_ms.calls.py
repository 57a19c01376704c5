"""Capture and host prep: the harness's span around each call, from
entry to return and before the barrier, in ms: the total over the
window's calls outside the traced sub-window, over their count."""


def read(run):
    spans = run.window.get("spans", {}).get("call_issue_s", [])
    return 1e3 * sum(spans) / len(spans) if spans else None

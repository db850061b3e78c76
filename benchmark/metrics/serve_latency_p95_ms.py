"""The 95th percentile of submit-to-answer latency over the requests
answered in the traced window (a failed request counts as missing)."""


def read(view):
    return view["counters"].get("latency_p95_ms")

"""server.padded_pct: padding rows over all rows dispatched in the window
(InferenceServer.stats)."""


def read(run):
    s = run.window.server
    if not s or not (s["requests"] + s["padded"]):
        return None
    return 100.0 * s["padded"] / (s["requests"] + s["padded"])

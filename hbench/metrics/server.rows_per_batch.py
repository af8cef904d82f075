"""server.rows_per_batch: requests answered over batches run in the window
(InferenceServer.stats)."""


def read(run):
    s = run.window.server
    if not s or not s["batches"]:
        return None
    return s["requests"] / s["batches"]

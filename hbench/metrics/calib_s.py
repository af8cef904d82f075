"""calib_s: the harness clock around quantize_graph (the configuration's
calibration: MinMax, or KL with its histograms)."""


def read(run):
    return run.calib_s

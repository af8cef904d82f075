"""calib_s: the harness clock around quantize_graph (MinMax calibration)."""


def read(run):
    return run.calib_s

"""elementwise_ms: device ms one forward spends in PyTorch's elementwise and
reduction kernels (the requant passes), by kernel name from a trace of
forwards made back to back after the window."""

from hbench.reduce import per_fwd


def read(run):
    return per_fwd(run, "elementwise_ms")

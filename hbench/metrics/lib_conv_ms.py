"""lib_conv_ms: device ms one forward spends in the library's conv and GEMM
kernels (the fast lowering's float64 convs), by kernel name from a trace of
forwards made back to back after the window."""

from hbench.reduce import per_fwd


def read(run):
    return per_fwd(run, "lib_conv_ms")

"""own_kernel_ms: device ms one forward spends in the program's hand-written
kernels (tengine_tpu_torch/csrc/*.cu: the convs, the stem, the block chain,
qwiden and qrequant), by kernel name from a trace of forwards made back to
back after the window."""

from hbench.reduce import per_fwd


def read(run):
    return per_fwd(run, "own_kernel_ms")

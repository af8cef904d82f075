"""mfu_pct: int8 operations of the images answered in the window (the
frozen count of hbench/counts.py, padding rows not counted) over the
window's seconds and 1,979 TOP/s a card it ran on."""

from hbench.reduce import mfu_pct


def read(run):
    return mfu_pct(run)

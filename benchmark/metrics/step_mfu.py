"""The whole step's share of the card's peak: the least time one step could
take, from the frozen count of `work.step` at the cell's sizes, over the
window's measured time per step (host clock, the whole window)."""

from benchmark import work

UNIT = "%"


def read(run):
    nbytes, flops = work.step(run.sizes)
    least = work.bound_seconds(nbytes, flops, run.sizes["dtype"])
    return 100.0 * least / (run.window_s / run.window_steps)

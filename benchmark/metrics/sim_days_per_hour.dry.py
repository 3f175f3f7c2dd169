"""Simulated days an hour over the whole window (steps × dt over the
window's wall time on the host's clock, ending in a synchronisation), read
per layer in cells where the host's dispatch sets the pace of a step and
the rate swings with the host's speed from run to run by more than any
bound could hold."""

UNIT = "days/h"


def read(run):
    return (run.window_steps * run.sizes["dt"] / 86400.0) / (
        run.window_s / 3600.0)

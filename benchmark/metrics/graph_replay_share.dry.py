"""`graph_replay_share` in the cells that report no rate end to end
(`dry_120km`): the program's `step.graph` spans in the traced steps over
the traced steps, in percent; nothing where the trace holds none."""

from benchmark.metrics.graph_replay_share import UNIT, read  # noqa: F401

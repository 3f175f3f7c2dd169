"""Host set-up's initial condition: the seconds `build_model` spent in
`init_jw` (`Model.setup_seconds`, a counter of the program)."""

UNIT = "s"


def read(run):
    return run.setup_stages.get("init_jw")

"""Host syncs that one train step makes, counted by torch's sync debug mode
over one step after the window."""


def read(run):
    return run.counters.get("host_syncs_per_step")

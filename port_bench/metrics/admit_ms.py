"""Mean wall time of one admission in the window: ``DecodeEngine.stats``'s
``admit_s`` over ``admissions`` (each admission ends on the host's read of
its sampled token, so the time is the device's too)."""


def read(run):
    c = run.counters
    if not c.get("admissions"):
        return None
    return 1e3 * c["admit_s"] / c["admissions"]

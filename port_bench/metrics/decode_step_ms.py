"""Mean wall time of one decode step in the window: ``DecodeEngine.stats``'s
``decode_s`` over ``decode_steps`` (each step ends on the host's read of
the sampled tokens)."""


def read(run):
    c = run.counters
    if not c.get("decode_steps"):
        return None
    return 1e3 * c["decode_s"] / c["decode_steps"]

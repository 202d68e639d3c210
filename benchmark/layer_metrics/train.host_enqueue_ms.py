"""The host's time to queue one train step: the benchmark's span from
the step call to its return, each of ``enqueue_steps`` steps started on
an idle card (so no full launch queue holds the call back), averaged."""


def read(result):
    s = result.counters.get("host_enqueue_s")
    return None if s is None else 1e3 * s

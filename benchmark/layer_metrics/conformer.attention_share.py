"""The share of the card's busy time in the traced stretch spent in the
Conformer's relative-position attention: the device seconds between the
event pairs of the span ``conformer.attention`` (six a batch, one a
block: the q, k, v and position products, the [T', T'] score chain, the
product with v, the output product), over the stretch's busy seconds.
None without a trace or where the program has no such span."""

SPAN = "conformer.attention"


def read(result):
    t = result.trace
    if t is None or t.busy_s <= 0:
        return None
    try:
        from asv_subtools_tpu_torch.utils.profiling import totals
    except ImportError:  # a program without spans
        return None
    got = totals().get(SPAN)
    if got is None or got[2] is None:
        return None
    return 100.0 * got[2] / t.busy_s

"""The Conformer's relative-position attention in the traced stretch: the
least time of its work (six layers a batch at the batch's padded T',
``counts/conformer.py``: the q, k, v, position and output products and
the three [T', T'] products a head at the bf16 peak; x read once, the
weights, the output written once at the memory's peak) over the device
seconds of the span ``conformer.attention``. None without a trace or
where the program has no such span."""

from benchmark.counts import conformer, peaks

SPAN = "conformer.attention"


def read(result):
    t = result.trace
    if t is None or not t.work:
        return None
    try:
        from asv_subtools_tpu_torch.utils.profiling import totals
    except ImportError:  # a program without spans
        return None
    got = totals().get(SPAN)
    if got is None or not got[2]:
        return None
    need = sum(peaks.bound_s(*fb) for fb in conformer.attention_work(result.config, t.work))
    return 100.0 * need / got[2]

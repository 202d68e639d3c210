"""The rate of the Extractor's copies to the card in the traced stretch:
the counter ``extract.copy_in_bytes`` (the padded waves' and masks'
bytes) over the span ``extract.copy_in``'s host seconds, in GB/s. None
without a trace or where the program has neither."""


def read(result):
    if result.trace is None:
        return None
    try:
        from asv_subtools_tpu_torch.utils.profiling import totals
    except ImportError:  # a program without spans
        return None
    got = totals()
    span, sent = got.get("extract.copy_in"), got.get("extract.copy_in_bytes")
    if span is None or sent is None or span[1] <= 0:
        return None
    return sent / span[1] * 1e-9

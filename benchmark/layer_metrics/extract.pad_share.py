"""Padding's share of the samples the Extractor sent to the card in the
window: 1 - valid samples (the Extractor's ``frames`` counter, which
counts samples in wave mode) over the samples of the padded batches (the
shapes of the embed calls the benchmark recorded)."""


def read(result):
    c = result.counters
    if not c.get("sent_samples"):
        return None
    return 100.0 * (1.0 - c["valid_samples"] / c["sent_samples"])

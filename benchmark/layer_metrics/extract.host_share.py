"""The share of the window spent outside the Extractor's own timed span
around copy-in, the embed call and copy-out (its ``device_s`` counter):
per-item chunking, padding into numpy and batch assembly on the host."""


def read(result):
    c = result.counters
    if not c.get("window_s"):
        return None
    return 100.0 * (1.0 - c["extractor_span_s"] / c["window_s"])

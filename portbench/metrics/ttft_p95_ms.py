"""ttft_p95_ms (ms): the 95th percentile, over every request submitted
in the window, of its first token's time less its submission's; a request
with no first token by the window's end counts at the window's end (host
clock)."""

from portbench.yardstick import percentile


def read(record):
    serve = record.get("serve")
    if serve is None or not serve["ttft_s"]:
        return None
    return percentile(serve["ttft_s"], 95) * 1e3

"""tpot_p95_ms (ms): the 95th percentile of every gap between two
consecutive tokens of a request, over all requests, where both tokens
lie in the window (host clock). A stall lengthens the gap of every
stream it holds up. The gap between the prefill's token and the first
wave's, which come in one step, is none and is left out."""

import numpy as np

from portbench.yardstick import percentile


def read(record):
    serve = record.get("serve")
    if serve is None or not serve["gaps"]:
        return None
    length, count = np.asarray(serve["gaps"], dtype=np.float64).T
    return percentile(np.repeat(length, count.astype(np.int64)), 95) * 1e3

"""prefill_device_share (%): device time of the prefill calls over the
length of the part of the window they fall in (the traced run's window
up to its profiled tail; layer: prefill)."""


def read(record):
    sp = record.get("spans")
    if not sp or sp["prefill_device_s"] is None or not sp["window_s"]:
        return None
    return 100.0 * sp["prefill_device_s"] / sp["window_s"]

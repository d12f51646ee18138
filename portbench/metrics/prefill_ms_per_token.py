"""prefill_ms_per_token (ms/token): device time of the window's prefill
calls (CUDA events around the backend's prefill) over the prompt tokens
they took (layer: prefill)."""


def read(record):
    sp = record.get("spans")
    if not sp or sp["prefill_device_s"] is None or not sp["prefill_tokens"]:
        return None
    return sp["prefill_device_s"] / sp["prefill_tokens"] * 1e3

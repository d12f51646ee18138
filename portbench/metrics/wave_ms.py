"""wave_ms (ms): device time per decode wave, over every wave of the
window (CUDA events around each wave; layer: decode wave)."""


def read(record):
    sp = record.get("spans")
    if not sp or sp["wave_device_s"] is None or not sp["n_waves"]:
        return None
    return sp["wave_device_s"] / sp["n_waves"] * 1e3

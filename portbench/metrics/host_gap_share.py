"""host_gap_share (%): the share of the traced run's window, up to its
profiled tail, that lies outside the device time of the prefill calls
and decode waves (CUDA events around each: all the work a serving step
sends to the device): the host's time between them, in the client loop,
the scheduler and the session's bookkeeping. Gaps on the device inside
a call (an eager, host-paced prefill) count as the call's; the device's
own idle share is ``device.busy_s`` / ``window_s`` of the profiler's
trace (layer: session and scheduling)."""


def read(record):
    sp = record.get("spans")
    if (not sp or "serve" not in record or not sp["window_s"]
            or sp["wave_device_s"] is None):
        return None
    busy = sp["wave_device_s"] + (sp["prefill_device_s"] or 0.0)
    return 100.0 * (1.0 - busy / sp["window_s"])

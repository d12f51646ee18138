"""decode_mfu (%): the window's waves' model FLOPs (2 per parameter a token
multiplies by, plus attention over the tokens of the pages it reads, or
RWKV6's recurrence; the architecture's ``decode_flops``) over the waves' device
time and the card's 989 TFLOP/s (layer: decode wave)."""

from portbench.yardstick import BF16_FLOPS


def read(record):
    sp = record.get("spans")
    if not sp or not sp["wave_device_s"]:
        return None
    return 100.0 * sp["wave_flops"] / (sp["wave_device_s"] * BF16_FLOPS)

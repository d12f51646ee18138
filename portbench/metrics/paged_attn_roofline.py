"""paged_attn_roofline (%): the least time of the profiled waves' paged
attention calls (``yardstick.paged_call``: each selected page's valid
tokens read once, q read and the output written once, at 3.35 TB/s) over
the device time of ``sectored_paged_cluster_kernel`` in the trace
(layer: kernel)."""

KERNEL = "sectored_paged_cluster_kernel"


def read(record):
    prof = record.get("profile")
    if not prof or not prof.get("paged_bound_s"):
        return None
    spent = sum(s for name, s in prof["ops"].items() if KERNEL in name)
    if not spent:
        return None
    return 100.0 * prof["paged_bound_s"] / spent

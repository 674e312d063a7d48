"""exact_count_roofline: the exact count's bound (roofline.py, from each
call's shapes) over its profiled kernel time, in %.  The kernel's symbol
also serves exact_mask: a window that launched it reads nothing."""

from bench_torch import roofline


def read(tr):
    calls = tr.calls.get("exact_count", [])
    kernel_s = tr.seconds(lambda name: "::exact_kernel" in name)
    n_events = sum(1 for name, _, _ in tr.device if "::exact_kernel" in name)
    if (not calls or kernel_s <= 0 or n_events != len(calls)
            or tr.launches.get("exact_mask", 0)):
        return None
    bound = sum(roofline.exact_bound_s(c["n"], c["m"], c["bitmap_bytes"],
                                       c["guard"]) for c in calls)
    return 100.0 * bound / kernel_s

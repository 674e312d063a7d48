"""cascade_roofline: the cascade's bound (roofline.py, from each call's
shapes) over its profiled kernel time, in %."""

from bench_torch import roofline


def read(tr):
    calls = tr.calls.get("cascade", [])
    kernel_s = tr.seconds(lambda name: "::cascade_kernel" in name)
    n_events = sum(1 for name, _, _ in tr.device if "::cascade_kernel" in name)
    if not calls or kernel_s <= 0 or n_events != len(calls):
        return None
    fills = {}
    bound = 0.0
    for c in calls:
        bm = c["bitmaps"]
        key = (bm.data_ptr(), tuple(bm.shape))
        if key not in fills:
            fills[key] = roofline.bitmap_fills(bm)
        bound += roofline.cascade_bound_s(
            c["n"], c["m"], fills[key], c["k1"],
            bm.numel() * bm.element_size(), c["out_bytes"])
    return 100.0 * bound / kernel_s

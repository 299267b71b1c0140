"""The attention kernels' share of their roofline: the window's summed
least time of the attention work (``cotr_bench.flops.attention_bound_s`` of
each call the wrapper counted by shape: bytes at 3.35 TB/s or the two
products at the dtype's peak) over the device time of the kernels below in
the trace. The float32 kernel computes each product as three TF32
products, so one product's roofline caps it near a third."""

from cotr_bench import flops

KERNELS = ("attention_kernel_tile", "attention_kernel_row")


def read(m):
    by_name = m.trace.kernel_s()
    device = sum(s for n, s in by_name.items()
                 if any(k in n for k in KERNELS))
    if device <= 0.0:
        found = sorted(by_name, key=lambda n: -by_name[n])[:20]
        raise LookupError(f"attn_roofline.serve: no kernel named "
                          f"{KERNELS} in the trace; it holds {found}")
    if not m.shape_counts:
        raise LookupError("attn_roofline.serve: the window counted no "
                          "attention call")
    h = m.sizes["nheads"]
    hd = m.sizes["hidden_dim"] // h
    bound = sum(n * flops.attention_bound_s(b, lq, s, h, hd, dtype)
                for (b, lq, s, dtype), n in m.shape_counts.items())
    return 100.0 * bound / device

"""The prefill attention kernel's share of its roofline, in %: the least
time (at the chip's bf16 peak) for the causal attention of the uncached
prompt positions of every request whose first token came in the traced
slice, over the device time of the prefill attention kernels in the slice.
Layer: kernel #5 (``csrc/prefill_attention.cu``)."""

from loadbench import work

KERNELS = ("prefill_attn",)


def read(r):
    s, peaks = r.trace, r.peaks
    if s is None or peaks is None:
        return None
    t = s.seconds(lambda name: any(k in name for k in KERNELS))
    if t <= 0:
        return None
    flops = sum(
        work.attention_flops(r.arch, r.cached(x), len(x.prompt))
        for x in r.records if x.times and s.host_start <= x.times[0] < s.host_end
    )
    if not flops:
        return None
    return 100.0 * flops / peaks["bf16_flops"] / t

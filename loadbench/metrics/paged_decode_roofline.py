"""The paged decode kernel's share of its roofline, in %: the least time
(at the chip's HBM peak) for the bytes the decode tokens that came in the
traced slice needed (each token's K and V at every position it attends,
read once, its query read and its output written, in every layer), over
the device time of the paged decode kernels in the slice.  Layer: kernel
#2 (``csrc/decode_attention.cu``, the paged walk of
``csrc/paged_attention.cuh``)."""

from loadbench import work

KERNELS = ("paged_walk_attn", "paged_decode_attn")


def read(r):
    s, peaks = r.trace, r.peaks
    if s is None or peaks is None:
        return None
    t = s.seconds(lambda name: any(k in name for k in KERNELS))
    if t <= 0:
        return None
    nbytes = sum(
        work.decode_attention_bytes(r.arch, len(x.prompt) + j)
        for x in r.records for j, when in enumerate(x.times)
        if j > 0 and s.host_start <= when < s.host_end
    )
    if not nbytes:
        return None
    return 100.0 * nbytes / peaks["hbm_bytes"] / t
